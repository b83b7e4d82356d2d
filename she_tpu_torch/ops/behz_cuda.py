"""Launch wrappers for the BEHZ product's kernels (csrc/behz.cu).

The kernels replace the BEHZ passes that she_tpu leaves to XLA to fuse
(she_tpu/core/rns.py:312-461, bfv/bfv.py:723-793); ops/behz.py holds their
plain versions and the dispatch. Each wrapper checks its operands,
allocates its output with torch.empty, launches on
torch.cuda.current_stream() and raises if the launch reports a CUDA
error; there is no fallback. Each launch is counted in the tracer's
registry (launch.<kernel>; an empty batch launches nothing) and, while
tracing is on, by BehzKey,
so a run can show that its products went through the kernels and time
each shape it used.

The lift's and the floor's input is read in place (a view of a stacked
ciphertext, a transposed slice of the query, a block of N/S columns): its
base pointer with the sizes and strides of its batch axes (at most
key_switch_cuda.MAX_BATCH_AXES) and the stride of its RNS axis; its last
axis must be contiguous, its strides even and its base 16-byte aligned
(the kernels load two coefficients at a time). The MAC takes contiguous
[..., K, 2, M, n] operands of one shape. Every output is contiguous. The
constants (punctured products and their inverses, Q mod b_j, m~^-1, Q^-1
mod b_j, B mod q_i, the scale, with their Barrett and Shoup words) are
made on the host once per moduli and passed by value with the launch.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from math import prod
from typing import NamedTuple

import torch

from .. import trace
from ..utils import nt
from . import kernel_build, key_switch_cuda
from .key_switch_cuda import MAX_MODULUS, Operand, operand

MAX_L = 8  # ciphertext moduli of a lift or a floor; L_bsk = L + 1
MAX_EXT = 2 * MAX_L + 1  # moduli of [q, B_sk]

_U64 = ctypes.c_uint64


class Mod(ctypes.Structure):
    _fields_ = [("q", _U64), ("r_lo", _U64), ("r_hi", _U64)]


class LiftParams(ctypes.Structure):
    _fields_ = [
        ("q", Mod * MAX_L), ("w", _U64 * MAX_L), ("ws", _U64 * MAX_L),
        ("b", Mod * (MAX_L + 1)), ("punct_b", (_U64 * MAX_L) * (MAX_L + 1)), ("punct_mt", _U64 * MAX_L),
        ("q_mod_b", _U64 * (MAX_L + 1)), ("q_mod_b_s", _U64 * (MAX_L + 1)),
        ("inv_mt", _U64 * (MAX_L + 1)), ("inv_mt_s", _U64 * (MAX_L + 1)),
        ("neg_inv_q_mt", _U64), ("m_tilde", _U64),
    ]


def _floor_fields(word) -> list:
    L, B = MAX_L, MAX_L + 1
    return [
        ("q", word * L), ("b", word * B), ("zq", word * L), ("zq_s", word * L), ("xc", word * B), ("xc_s", word * B),
        ("zc", (word * L) * B), ("zc_s", (word * L) * B), ("bc", word * L), ("bc_s", word * L),
        ("bq", (word * L) * L), ("bq_s", (word * L) * L), ("b_mod_q", word * L), ("b_mod_q_s", word * L),
        ("neg_b_mod_q", word * L), ("neg_b_mod_q_s", word * L),
    ]


class FloorParams64(ctypes.Structure):
    _fields_ = _floor_fields(_U64)


class FloorParams32(ctypes.Structure):
    _fields_ = _floor_fields(ctypes.c_uint32)


class MacParams(ctypes.Structure):
    _fields_ = [("m", Mod * MAX_EXT), ("s", _U64 * MAX_EXT), ("ss", _U64 * MAX_EXT)]


class BehzKey(NamedTuple):
    """What a launch is counted by in the tracer's shape table: the kernel, the
    shape of its input (x, la, y), the moduli ((q, B_sk) for the lift and
    the floor, those of [q, B_sk] for the MAC) and the kernel's variant:
    (m~, the input's strides) for behz_lift, (scale,) for behz_tensor_mac,
    (scale, the input's strides) for behz_floor."""

    name: str
    shape: tuple
    moduli: tuple
    variant: tuple



_VP = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong
_OP = ctypes.POINTER(Operand)
_ARGTYPES = {
    "she_behz_lift": [_OP, _VP, _LL, _INT, _INT, ctypes.POINTER(LiftParams), _VP],
    "she_behz_floor": [_OP, _VP, _LL, _INT, _INT, _INT, _VP, _VP],
    "she_behz_tensor_mac": [_VP, _VP, _VP, _LL, _INT, _INT, _INT, ctypes.POINTER(MacParams), _VP],
}


def _library():
    lib = kernel_build.load("behz")
    if lib.she_behz_param_bytes.restype is not _LL:
        lib.she_behz_param_bytes.argtypes, lib.she_behz_param_bytes.restype = [_INT], _LL
        for which, struct in enumerate((LiftParams, FloorParams64, MacParams, Operand, FloorParams32)):
            if lib.she_behz_param_bytes(which) != ctypes.sizeof(struct):
                raise RuntimeError(f"{struct.__name__} is {ctypes.sizeof(struct)} bytes here, "
                                   f"{lib.she_behz_param_bytes(which)} in csrc/behz.cu")
        for name, args in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def _mod(q: int) -> Mod:
    r = (1 << 128) // q
    return Mod(q, r & ((1 << 64) - 1), r >> 64)


def _shoup(w: int, q: int) -> tuple[int, int]:
    """A constant reduced mod q and its Shoup word floor(w 2^64 / q)."""
    w %= q
    return w, (w << 64) // q


def _check_moduli(q_moduli: tuple, bsk_moduli: tuple) -> None:
    if not 1 <= len(q_moduli) <= MAX_L or len(bsk_moduli) != len(q_moduli) + 1:
        raise ValueError(f"the BEHZ kernels take 1 to {MAX_L} moduli q and L + 1 of B_sk, got {len(q_moduli)} "
                         f"and {len(bsk_moduli)}")
    moduli = q_moduli + bsk_moduli
    if max(moduli) >= MAX_MODULUS or min(moduli) < 2:
        raise ValueError(f"the BEHZ kernels take moduli in [2, 2^62), got {moduli}")


@lru_cache(maxsize=None)
def lift_params(q_moduli: tuple, bsk_moduli: tuple, m_tilde: int) -> LiftParams:
    _check_moduli(q_moduli, bsk_moduli)
    if m_tilde & (m_tilde - 1) or not 2 <= m_tilde <= 1 << 32:
        raise ValueError(f"m~ must be a power of two up to 2^32, got {m_tilde}")
    p = LiftParams()
    Q = 1
    for q in q_moduli:
        Q *= q
    for i, q in enumerate(q_moduli):
        p.q[i] = _mod(q)
        p.w[i], p.ws[i] = _shoup(m_tilde * nt.inverse_mod((Q // q) % q, q), q)
        p.punct_mt[i] = (Q // q) % m_tilde
    for j, b in enumerate(bsk_moduli):
        p.b[j] = _mod(b)
        for i, q in enumerate(q_moduli):
            p.punct_b[j][i] = (Q // q) % b
        p.q_mod_b[j], p.q_mod_b_s[j] = _shoup(Q, b)
        p.inv_mt[j], p.inv_mt_s[j] = _shoup(nt.inverse_mod(m_tilde % b, b), b)
    p.neg_inv_q_mt = (-nt.inverse_mod(Q % m_tilde, m_tilde)) % m_tilde
    p.m_tilde = m_tilde
    return p


def floor_word_bits(q_moduli: tuple, bsk_moduli: tuple) -> int:
    """The floor kernel's instance: 32-bit words where every modulus of q
    and B_sk is below 2^32 (every w32 set), else 64."""
    return 32 if max(q_moduli + bsk_moduli) < 1 << 32 else 64


@lru_cache(maxsize=None)
def floor_params(q_moduli: tuple, bsk_moduli: tuple, scale: int) -> ctypes.Structure:
    """The floor's constants for its instance (floor_word_bits): a
    FloorParams32 or FloorParams64, each constant reduced mod its modulus
    with its Shoup word floor(w 2^bits / m). The scale s, Q^-1 mod b_j,
    (B/b_j)^-1 mod b_j and B^-1 mod m_sk are folded into the constants of
    the terms they multiply (csrc/behz.cu, behz_floor_kernel)."""
    _check_moduli(q_moduli, bsk_moduli)
    bits = floor_word_bits(q_moduli, bsk_moduli)
    p = (FloorParams32 if bits == 32 else FloorParams64)()
    L = len(q_moduli)
    b_moduli, m_sk = bsk_moduli[:-1], bsk_moduli[-1]
    Q, B = 1, 1
    for q in q_moduli:
        Q *= q
    for b in b_moduli:
        B *= b

    def shoup(w: int, m: int) -> tuple[int, int]:
        w %= m
        return w, (w << bits) // m

    inv_b_msk = nt.inverse_mod(B % m_sk, m_sk)
    for i, q in enumerate(q_moduli):
        p.q[i] = q
        p.zq[i], p.zq_s[i] = shoup(scale * nt.inverse_mod((Q // q) % q, q), q)
        for j, b in enumerate(b_moduli):
            p.bq[i][j], p.bq_s[i][j] = shoup(B // b, q)
        p.b_mod_q[i], p.b_mod_q_s[i] = shoup(B, q)
        p.neg_b_mod_q[i], p.neg_b_mod_q_s[i] = shoup(-B, q)
    for j, b in enumerate(bsk_moduli):
        p.b[j] = b
        inv_q = nt.inverse_mod(Q % b, b)
        # what follows the row's sum: (B/b_j)^-1 over B, -B^-1 at m_sk (alpha's sign)
        after = nt.inverse_mod((B // b) % b, b) if j < L else -inv_b_msk
        p.xc[j], p.xc_s[j] = shoup(scale * inv_q * after, b)
        for i, q in enumerate(q_moduli):
            p.zc[j][i], p.zc_s[j][i] = shoup(-(Q // q) * inv_q * after, b)
    for j, b in enumerate(b_moduli):
        p.bc[j], p.bc_s[j] = shoup((B // b) * inv_b_msk, m_sk)
    return p


@lru_cache(maxsize=None)
def mac_params(moduli: tuple, scale: int) -> MacParams:
    if not 1 <= len(moduli) <= MAX_EXT or max(moduli) >= MAX_MODULUS or min(moduli) < 2:
        raise ValueError(f"the BEHZ MAC takes 1 to {MAX_EXT} moduli in [2, 2^62), got {moduli}")
    p = MacParams()
    for i, m in enumerate(moduli):
        p.m[i] = _mod(m)
        p.s[i], p.ss[i] = _shoup(scale, m)
    return p


def _check_columns(n: int) -> None:
    if n < 2 or n % 2:
        raise ValueError(f"the BEHZ kernels take an even column count of at least 2, got {n}")


def behz_lift(x: torch.Tensor, q_moduli: tuple, bsk_moduli: tuple, m_tilde: int) -> torch.Tensor:
    """x [..., L, n] over q (read in place) -> [..., L + L_bsk, n] over
    [q, B_sk], the q rows copied."""
    params = lift_params(tuple(q_moduli), tuple(bsk_moduli), m_tilde)
    L, n = len(q_moduli), x.shape[-1]
    _check_columns(n)
    op, batch = operand(x, L, n, what="x")
    out = torch.empty(batch + (2 * L + 1, n), dtype=torch.int64, device=x.device)
    m = out.numel() // ((2 * L + 1) * n)
    if m:
        err = _library().she_behz_lift(ctypes.byref(op), out.data_ptr(), m, L, n, ctypes.byref(params), key_switch_cuda._stream())
        key_switch_cuda._raise_on(err, "behz_lift")
        if trace.launch("behz_lift"):
            trace.count_shape("behz_lift", BehzKey("behz_lift", tuple(x.shape), (tuple(q_moduli), tuple(bsk_moduli)),
                                                   (m_tilde, tuple(x.stride()))))
    return out


class _FloorLaunch(NamedTuple):
    """What a floor's launch shape needs beside its input's and output's
    pointers, made once per shape: its key, the output's shape, the
    Operand (its base filled in at each call) and the C call's arguments."""

    key: BehzKey
    out_shape: tuple
    op: Operand
    args: list


@lru_cache(maxsize=1024)
def _floor_launch(shape: tuple, strides: tuple, q_moduli: tuple, bsk_moduli: tuple, scale: int) -> _FloorLaunch:
    params = floor_params(q_moduli, bsk_moduli, scale)
    L, n = len(q_moduli), shape[-1]
    _check_columns(n)
    op, batch = key_switch_cuda.layout(shape, strides, 2 * L + 1, n, what="y")
    m = prod(batch)
    args = [ctypes.byref(op), None, m, L, n, floor_word_bits(q_moduli, bsk_moduli), ctypes.addressof(params), None]
    key = BehzKey("behz_floor", shape, (q_moduli, bsk_moduli), (scale, strides))
    return _FloorLaunch(key, batch + (L, n), op, args)


def behz_floor(y: torch.Tensor, q_moduli: tuple, bsk_moduli: tuple, scale: int = 1) -> torch.Tensor:
    """y [..., L + L_bsk, n] over [q, B_sk] (read in place; each row times
    `scale` first) -> floor(x / q) [..., L, n] over q. The launch is made
    once per shape (_floor_launch): a floor takes about as long as the
    host's work for a call."""
    q_moduli, bsk_moduli = tuple(q_moduli), tuple(bsk_moduli)
    floor_params(q_moduli, bsk_moduli, scale)  # the moduli's checks first
    _check_columns(y.shape[-1])
    key_switch_cuda._check_tensor(y, "y")
    launch = _floor_launch(tuple(y.shape), y.stride(), q_moduli, bsk_moduli, scale)
    if y.data_ptr() % 16:
        raise ValueError("y needs even strides and a 16-byte aligned base")
    out = torch.empty(launch.out_shape, dtype=torch.int64, device=y.device)
    if out.numel():
        launch.op.base = y.data_ptr()
        args = launch.args
        args[1], args[-1] = out.data_ptr(), key_switch_cuda._stream()
        key_switch_cuda._raise_on(_library().she_behz_floor(*args), "behz_floor")
        if trace.launch("behz_floor"):
            trace.count_shape("behz_floor", launch.key)
    return out


def behz_tensor_mac(la: torch.Tensor, lb: torch.Tensor, moduli: tuple, scale: int = 1) -> torch.Tensor:
    """la, lb [..., K, 2, M, n] (contiguous, one shape) -> [..., 3, M, n]:
    p0 = sum a0 b0, p1 = sum a0 b1 + a1 b0, p2 = sum a1 b1 over K, each
    times `scale` mod its modulus."""
    params = mac_params(tuple(moduli), scale)
    M = len(moduli)
    key_switch_cuda._check_contiguous(la, "la")
    key_switch_cuda._check_contiguous(lb, "lb")
    if la.shape != lb.shape or la.device != lb.device:
        raise ValueError(f"la {tuple(la.shape)} on {la.device} and lb {tuple(lb.shape)} on {lb.device} must agree")
    if la.dim() < 4 or tuple(la.shape[-3:-1]) != (2, M):
        raise ValueError(f"la must be [..., K, 2, {M}, n], got {tuple(la.shape)}")
    K, n = la.shape[-4], la.shape[-1]
    _check_columns(n)
    if K < 1:
        raise ValueError("the BEHZ MAC takes at least one pair")
    if la.data_ptr() % 16 or lb.data_ptr() % 16:
        raise ValueError("la and lb need a 16-byte aligned base")
    batch = tuple(la.shape[:-4])
    out = torch.empty(batch + (3, M, n), dtype=torch.int64, device=la.device)
    m = out.numel() // (3 * M * n)
    if m:
        err = _library().she_behz_tensor_mac(la.data_ptr(), lb.data_ptr(), out.data_ptr(), m, K, M, n,
                                             ctypes.byref(params), key_switch_cuda._stream())
        key_switch_cuda._raise_on(err, "behz_tensor_mac")
        if trace.launch("behz_tensor_mac"):
            trace.count_shape("behz_tensor_mac", BehzKey("behz_tensor_mac", tuple(la.shape), tuple(moduli),
                                                         (scale,)))
    return out
