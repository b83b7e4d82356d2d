"""Launch wrappers for the BEHZ product's kernels (csrc/behz.cu).

The kernels replace the BEHZ passes that she_tpu leaves to XLA to fuse
(she_tpu/core/rns.py:312-461, bfv/bfv.py:723-793); ops/behz.py holds their
plain versions and the dispatch. Each wrapper checks its operands,
allocates its output with torch.empty, launches on
torch.cuda.current_stream() and raises if the launch reports a CUDA
error; there is no fallback. `launches` counts each kernel's launches (an
empty batch launches nothing) and `launch_shapes` counts them by BehzKey,
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
from collections import Counter
from functools import lru_cache
from typing import NamedTuple

import torch

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


class FloorParams(ctypes.Structure):
    _fields_ = [
        ("q", Mod * MAX_L), ("b", Mod * (MAX_L + 1)),
        ("sq", _U64 * MAX_L), ("sq_s", _U64 * MAX_L), ("sb", _U64 * (MAX_L + 1)), ("sb_s", _U64 * (MAX_L + 1)),
        ("inv_punct_q", _U64 * MAX_L), ("inv_punct_q_s", _U64 * MAX_L),
        ("punct_q_b", (_U64 * MAX_L) * (MAX_L + 1)),
        ("inv_q_b", _U64 * (MAX_L + 1)), ("inv_q_b_s", _U64 * (MAX_L + 1)),
        ("inv_punct_b", _U64 * MAX_L), ("inv_punct_b_s", _U64 * MAX_L), ("punct_b_msk", _U64 * MAX_L),
        ("punct_b_q", (_U64 * MAX_L) * MAX_L), ("inv_b_msk", _U64), ("inv_b_msk_s", _U64),
        ("b_mod_q", _U64 * MAX_L), ("b_mod_q_s", _U64 * MAX_L),
        ("neg_b_mod_q", _U64 * MAX_L), ("neg_b_mod_q_s", _U64 * MAX_L), ("scaled", _U64),
    ]


class MacParams(ctypes.Structure):
    _fields_ = [("m", Mod * MAX_EXT), ("s", _U64 * MAX_EXT), ("ss", _U64 * MAX_EXT)]


class BehzKey(NamedTuple):
    """What a launch is counted by in `launch_shapes`: the kernel, the
    shape of its input (x, la, y), the moduli ((q, B_sk) for the lift and
    the floor, those of [q, B_sk] for the MAC) and the kernel's variant:
    (m~, the input's strides) for behz_lift, (scale,) for behz_tensor_mac,
    (scale, the input's strides) for behz_floor."""

    name: str
    shape: tuple
    moduli: tuple
    variant: tuple


launches = {"behz_lift": 0, "behz_tensor_mac": 0, "behz_floor": 0}
launch_shapes: Counter = Counter()

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong
_OP = ctypes.POINTER(Operand)
_ARGTYPES = {
    "she_behz_lift": [_OP, _VP, _LL, _INT, _INT, ctypes.POINTER(LiftParams), _VP],
    "she_behz_floor": [_OP, _VP, _LL, _INT, _INT, ctypes.POINTER(FloorParams), _VP],
    "she_behz_tensor_mac": [_VP, _VP, _VP, _LL, _INT, _INT, _INT, ctypes.POINTER(MacParams), _VP],
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    launch_shapes.clear()


def _library():
    lib = kernel_build.load("behz")
    if lib.she_behz_param_bytes.restype is not _LL:
        lib.she_behz_param_bytes.argtypes, lib.she_behz_param_bytes.restype = [_INT], _LL
        for which, struct in enumerate((LiftParams, FloorParams, MacParams, Operand)):
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


@lru_cache(maxsize=None)
def floor_params(q_moduli: tuple, bsk_moduli: tuple, scale: int) -> FloorParams:
    _check_moduli(q_moduli, bsk_moduli)
    p = FloorParams()
    b_moduli, m_sk = bsk_moduli[:-1], bsk_moduli[-1]
    Q, B = 1, 1
    for q in q_moduli:
        Q *= q
    for b in b_moduli:
        B *= b
    for i, q in enumerate(q_moduli):
        p.q[i] = _mod(q)
        p.sq[i], p.sq_s[i] = _shoup(scale, q)
        p.inv_punct_q[i], p.inv_punct_q_s[i] = _shoup(nt.inverse_mod((Q // q) % q, q), q)
        for j, b in enumerate(b_moduli):
            p.punct_b_q[i][j] = (B // b) % q
        p.b_mod_q[i], p.b_mod_q_s[i] = _shoup(B, q)
        p.neg_b_mod_q[i], p.neg_b_mod_q_s[i] = _shoup(-B, q)
    for j, b in enumerate(bsk_moduli):
        p.b[j] = _mod(b)
        p.sb[j], p.sb_s[j] = _shoup(scale, b)
        for i, q in enumerate(q_moduli):
            p.punct_q_b[j][i] = (Q // q) % b
        p.inv_q_b[j], p.inv_q_b_s[j] = _shoup(nt.inverse_mod(Q % b, b), b)
    for j, b in enumerate(b_moduli):
        p.inv_punct_b[j], p.inv_punct_b_s[j] = _shoup(nt.inverse_mod((B // b) % b, b), b)
        p.punct_b_msk[j] = (B // b) % m_sk
    p.inv_b_msk, p.inv_b_msk_s = _shoup(nt.inverse_mod(B % m_sk, m_sk), m_sk)
    p.scaled = int(any(scale % m != 1 for m in q_moduli + bsk_moduli))
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
        launches["behz_lift"] += 1
        launch_shapes[BehzKey("behz_lift", tuple(x.shape), (tuple(q_moduli), tuple(bsk_moduli)),
                              (m_tilde, tuple(x.stride())))] += 1
    return out


def behz_floor(y: torch.Tensor, q_moduli: tuple, bsk_moduli: tuple, scale: int = 1) -> torch.Tensor:
    """y [..., L + L_bsk, n] over [q, B_sk] (read in place; each row times
    `scale` first) -> floor(x / q) [..., L, n] over q."""
    params = floor_params(tuple(q_moduli), tuple(bsk_moduli), scale)
    L, n = len(q_moduli), y.shape[-1]
    _check_columns(n)
    op, batch = operand(y, 2 * L + 1, n, what="y")
    out = torch.empty(batch + (L, n), dtype=torch.int64, device=y.device)
    m = out.numel() // (L * n)
    if m:
        err = _library().she_behz_floor(ctypes.byref(op), out.data_ptr(), m, L, n, ctypes.byref(params), key_switch_cuda._stream())
        key_switch_cuda._raise_on(err, "behz_floor")
        launches["behz_floor"] += 1
        launch_shapes[BehzKey("behz_floor", tuple(y.shape), (tuple(q_moduli), tuple(bsk_moduli)),
                              (scale, tuple(y.stride())))] += 1
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
        launches["behz_tensor_mac"] += 1
        launch_shapes[BehzKey("behz_tensor_mac", tuple(la.shape), tuple(moduli), (scale,))] += 1
    return out
