"""BFV scheme: contexts, keys, encode/encrypt/decrypt, ciphertext ops.

The port of she_tpu/bfv/bfv.py (reference Sources/HomomorphicEncryption/
Bfv/*.swift) over int64 tensors on one torch device. Host side: parameter
and table precomputation, AES-CTR-DRBG sampling (the same byte streams, so
seeded ciphertexts are bit-identical). Device side: NTTs, modular
multiply-adds, scaling.

Every ciphertext op accepts polynomials with leading batch axes: the data
of each poly is [..., L, N] and all polys of a ciphertext share the batch
shape. Canonical ciphertext format is Coeff, fresh ciphertexts have 2
polys, and the last coefficient modulus is reserved for key switching, as
in the reference (Bfv.swift:31-41).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .. import errors
from ..core import poly as polymod
from ..core import rns as rnsmod
from ..core.context import PolyContext, get_poly_context
from ..core.poly import COEFF, EVAL, PolyRq
from ..device import resolve_device
from ..ops import galois as galoismod
from ..ops import modarith as ma
from ..ops import ntt as nttmod
from ..ops import wide
from ..params import EncryptionParameters
from ..rng import sampling
from ..rng.ctr_drbg import SystemRng, nist_aes128_ctr
from ..utils import nt

SEED_BYTES = 32
FRESH_CIPHERTEXT_POLY_COUNT = 2


def get_bfv_context(params: EncryptionParameters, device=None) -> "BfvContext":
    """The BFV context for `params` on `device` (the CUDA card by default)."""
    return _bfv_context(params, resolve_device(device))


@lru_cache(maxsize=None)
def _bfv_context(params: EncryptionParameters, device: torch.device) -> "BfvContext":
    return BfvContext(params, device)


class BfvContext:
    """Per-parameter precomputation (reference Context.swift:94-143)."""

    def __init__(self, params: EncryptionParameters, device: torch.device):
        self.params = params
        self.device = device
        bits = params.scalar_bits
        degree = params.poly_degree
        all_moduli = params.coefficient_moduli
        self.secret_key_context = get_poly_context(degree, all_moduli, bits, device)
        ct_moduli = all_moduli[:-1] if len(all_moduli) > 1 else all_moduli
        self.ciphertext_context = get_poly_context(degree, ct_moduli, bits, device)
        self.key_switch_modulus = all_moduli[-1] if len(all_moduli) > 1 else None
        self.plaintext_context = get_poly_context(
            degree, (params.plaintext_modulus,), bits, device
        )
        if self.key_switch_modulus is not None:
            self.key_switching_contexts = [
                get_poly_context(
                    degree, ct_moduli[: i + 1] + (self.key_switch_modulus,), bits, device
                )
                for i in range(len(ct_moduli))
            ]
        else:
            self.key_switching_contexts = []
        self.simd_matrix = self._generate_encoding_matrix()
        self.simd_index = None if self.simd_matrix is None else torch.from_numpy(self.simd_matrix).to(device)
        self._bsk_pool = rnsmod.bsk_prime_pool(degree, len(ct_moduli), bits)
        self._rns_tools: dict[int, rnsmod.RnsTool] = {}

    @property
    def degree(self) -> int:
        return self.params.poly_degree

    @property
    def plaintext_modulus(self) -> int:
        return self.params.plaintext_modulus

    @property
    def supports_simd_encoding(self) -> bool:
        return self.simd_matrix is not None

    @property
    def supports_evaluation_key(self) -> bool:
        return self.params.supports_evaluation_key

    def get_rns_tool(self, moduli_count: int) -> rnsmod.RnsTool:
        if moduli_count not in self._rns_tools:
            ctx = self.ciphertext_context.get_context(moduli_count)
            self._rns_tools[moduli_count] = rnsmod.RnsTool(
                ctx, self.plaintext_modulus, self._bsk_pool
            )
        return self._rns_tools[moduli_count]

    def _generate_encoding_matrix(self) -> np.ndarray | None:
        """SIMD slot -> Eval index, from powers of g=3, bit-reversed
        (reference Encoding.swift:197-219); None where t is not
        NTT-friendly for N."""
        t = self.params.plaintext_modulus
        n = self.params.poly_degree
        if not nt.is_ntt_modulus(t, n):
            return None
        log2n = nt.log2_exact(n)
        row_size = n >> 1
        mask = (n << 1) - 1
        idx = np.zeros(n, dtype=np.int64)
        g_pow = 1
        for i in range(row_size):
            idx[i] = nt.reverse_bits((g_pow - 1) >> 1, log2n)
            idx[row_size | i] = nt.reverse_bits((mask - g_pow) >> 1, log2n)
            g_pow = (g_pow * 3) & mask
        return idx

    def simd_dimensions(self) -> tuple[int, int] | None:
        """(rows, columns) of the SIMD slots, or None without SIMD."""
        if not self.supports_simd_encoding:
            return None
        return (2, self.degree // 2)


# ---------------------------------------------------------------------------
# Keys / plaintext / ciphertext containers
# ---------------------------------------------------------------------------


class SecretKey:
    """Ternary secret stored in Eval over the secret-key context
    (reference Bfv+Keys.swift:20-26).

    Lifecycle (she_tpu bfv/bfv.py:137-185; the reference zeroizes key
    material on deinit, Keys.swift:19-50): `zeroize()` overwrites the key's
    own storage with zeros in place, on the card or on the host, and drops
    it; any use after that raises. Also a context manager
    (`with generate_secret_key(ctx) as sk: ...`), and zeroized as a
    best-effort fallback when garbage-collected."""

    def __init__(self, poly: PolyRq):
        self._poly = poly  # eval, [L_all, N]

    @property
    def poly(self) -> PolyRq:
        if self._poly is None:
            raise errors.InvalidArgument("the secret key was zeroized")
        return self._poly

    def zeroize(self) -> None:
        poly, self._poly = getattr(self, "_poly", None), None
        if poly is not None:
            poly.data.zero_()

    def __enter__(self) -> "SecretKey":
        return self

    def __exit__(self, *exc) -> bool:
        self.zeroize()
        return False

    def __del__(self):  # best-effort deinit scrub, as in the reference
        try:
            self.zeroize()
        except Exception:
            pass


@dataclass
class Plaintext:
    context: BfvContext
    poly: PolyRq  # coeff over plaintext context, or eval over a ct context

    @property
    def fmt(self) -> str:
        return self.poly.fmt


@dataclass
class Ciphertext:
    context: BfvContext
    polys: list[PolyRq]
    correction_factor: int = 1
    seed: bytes | None = None

    @property
    def fmt(self) -> str:
        return self.polys[0].fmt

    @property
    def moduli_count(self) -> int:
        return len(self.polys[0].moduli)

    def poly_context(self) -> PolyContext:
        return self.polys[0].context

    def stacked(self) -> torch.Tensor:
        """[..., polys, L, N] tensor of all polys."""
        return torch.stack([p.data for p in self.polys], dim=-3)

    @classmethod
    def from_stacked(cls, context, data: torch.Tensor, poly_context: PolyContext,
                     fmt: str = COEFF, correction_factor: int = 1) -> "Ciphertext":
        """Inverse of stacked(): [..., polys, L, N] -> Ciphertext."""
        polys = [PolyRq(data[..., p, :, :], poly_context, fmt) for p in range(data.shape[-3])]
        return cls(context, polys, correction_factor)

    # operator ergonomics (reference Ciphertext.swift:115-500)
    def __add__(self, other):
        if isinstance(other, Plaintext):
            return ct_add_pt(self, other)
        return ct_add(self, other)

    def __sub__(self, other):
        if isinstance(other, Plaintext):
            return ct_sub_pt(self, other)
        return ct_sub(self, other)

    def __neg__(self):
        return ct_neg(self)

    def __mul__(self, other):
        if isinstance(other, Plaintext):
            return ct_mul_pt(self, other)
        return ct_mul(self, other)

    def decrypt(self, secret_key):
        return decrypt(self, secret_key)

    def noise_budget(self, secret_key):
        return noise_budget(self, secret_key)


# ---------------------------------------------------------------------------
# Key generation
# ---------------------------------------------------------------------------


def generate_secret_key(context: BfvContext, rng=None) -> SecretKey:
    """Ternary secret sampled in Coeff, stored in Eval
    (reference Bfv+Keys.swift:20-26)."""
    rng = rng or SystemRng()
    ctx = context.secret_key_context
    vals = sampling.sample_ternary(rng, list(ctx.moduli), ctx.degree)
    return SecretKey(polymod.forward_ntt(PolyRq.from_values(vals, ctx, COEFF)))


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _checked_values(context: BfvContext, values) -> np.ndarray:
    """values -> int64 array [..., k], k <= N, every value in [0, t)."""
    t = context.plaintext_modulus
    vals = np.asarray(values if isinstance(values, np.ndarray) else list(values), dtype=np.int64)
    if vals.shape[-1:] and vals.shape[-1] > context.degree:
        raise errors.EncodingError(f"{vals.shape[-1]} values > degree {context.degree}")
    if vals.size and (vals.min() < 0 or vals.max() >= t):
        raise errors.EncodingError(f"value out of range [0, {t})")
    return vals


def encode(context: BfvContext, values, fmt: str = "coefficient") -> Plaintext:
    """Unsigned values in [0, t) -> Coeff plaintext, in coefficient or SIMD
    format (reference Encoding.swift:160-234)."""
    vals = _checked_values(context, values)
    if fmt == "coefficient":
        row = np.zeros((1, context.degree), dtype=np.int64)
        row[0, : len(vals)] = vals
        return Plaintext(context, PolyRq.from_values(row, context.plaintext_context, COEFF))
    if fmt == "simd":
        data = encode_simd_batch(context, vals[None])[0]
        return Plaintext(context, PolyRq(data, context.plaintext_context, COEFF))
    raise errors.EncodingError(f"unknown format {fmt}")


def encode_simd_batch(context: BfvContext, rows) -> torch.Tensor:
    """SIMD-encode many plaintexts at once: integer array [B, k] (k <= N)
    of values in [0, t) -> int64 [B, 1, N] Coeff data mod t on the
    context's device. The values go to their slots' Eval positions, then
    ONE inverse NTT mod t transforms the whole batch; row b equals
    encode(context, rows[b], fmt="simd")."""
    if not context.supports_simd_encoding:
        raise errors.SimdEncodingNotSupported(str(context.params))
    vals = _checked_values(context, rows)
    B, k = vals.shape
    ev = torch.zeros((B, 1, context.degree), dtype=torch.int64, device=context.device)
    ev[:, 0, context.simd_index[:k]] = torch.from_numpy(vals).to(context.device)
    return nttmod.inverse_ntt(ev, context.plaintext_context.ntt_tables)


def encode_signed(context: BfvContext, values, fmt: str = "coefficient") -> Plaintext:
    """Signed values in [-(t // 2), (t - 1) // 2] -> plaintext."""
    t = context.plaintext_modulus
    vals = np.asarray(list(values), dtype=np.int64)
    lo, hi = -(t >> 1), (t - 1) >> 1
    if vals.size and (vals.min() < lo or vals.max() > hi):
        raise errors.EncodingError(f"signed value out of [{lo}, {hi}]")
    return encode(context, np.mod(vals, t), fmt)


def decode(context: BfvContext, plaintext: Plaintext, fmt: str = "coefficient") -> list[int]:
    """Coefficient or SIMD decoding of a plaintext (reference Encoding.swift)."""
    pt = plaintext
    if pt.poly.fmt == EVAL or pt.poly.context is not context.plaintext_context:
        pt = plaintext_to_coeff(plaintext)
    if fmt == "coefficient":
        return [int(v) for v in pt.poly.to_values()[0]]
    if fmt == "simd":
        if not context.supports_simd_encoding:
            raise errors.SimdEncodingNotSupported(str(context.params))
        ev = polymod.forward_ntt(pt.poly).data[0]
        return [int(v) for v in ev.index_select(-1, context.simd_index).cpu().numpy()]
    raise errors.EncodingError(f"unknown format {fmt}")


def decode_signed(context: BfvContext, plaintext: Plaintext, fmt: str = "coefficient") -> list[int]:
    t = context.plaintext_modulus
    return [v - t if v > (t - 1) >> 1 else v for v in decode(context, plaintext, fmt)]


def centered_lift(coeffs: torch.Tensor, t: int, poly_ctx: PolyContext) -> torch.Tensor:
    """[..., N] values mod t -> [..., L, N] centered lift into each q_i."""
    small = (coeffs < (t + 1) // 2).unsqueeze(-2)
    c = coeffs.unsqueeze(-2)
    return torch.where(small, c, c + (poly_ctx.q_col - t))


def plaintext_to_eval(context: BfvContext, plaintext: Plaintext, moduli_count: int | None = None) -> Plaintext:
    """Coeff (mod t) -> Eval (mod q_0..q_{c-1}) via the centered lift and
    ONE forward NTT (reference Plaintext.convertToEvalFormat,
    Plaintext.swift:149-171). The plaintext's data may carry leading batch
    axes, [..., 1, N]: every plaintext of the batch is converted at once."""
    if plaintext.poly.fmt == EVAL:
        return plaintext
    c = moduli_count or len(context.ciphertext_context.moduli)
    poly_ctx = context.ciphertext_context.get_context(c)
    lifted = centered_lift(plaintext.poly.data[..., 0, :], context.plaintext_modulus, poly_ctx)
    return Plaintext(context, polymod.forward_ntt(PolyRq(lifted, poly_ctx, COEFF)))


def batch_encode_to_eval(context: BfvContext, coeff_rows, moduli_count: int | None = None) -> torch.Tensor:
    """Batch-encode coefficient-format plaintexts (integer array [B, N] of
    values mod t) into Eval form over the first `moduli_count` ciphertext
    moduli with ONE batched NTT: returns int64 [B, L, N] on the context's
    device (database processing, she_tpu's batch_encode_to_eval)."""
    rows = torch.as_tensor(np.asarray(coeff_rows, dtype=np.int64), device=context.device)
    pt = Plaintext(context, PolyRq(rows.unsqueeze(-2), context.plaintext_context, COEFF))
    return plaintext_to_eval(context, pt, moduli_count).poly.data


def plaintext_to_coeff(plaintext: Plaintext) -> Plaintext:
    """Eval (mod q) -> Coeff (mod t) (reference Plaintext.swift:176-196)."""
    if plaintext.poly.fmt == COEFF and len(plaintext.poly.moduli) == 1:
        if plaintext.poly.context.moduli[0] == plaintext.context.plaintext_modulus:
            return plaintext
    context = plaintext.context
    t = context.plaintext_modulus
    coeff = polymod.inverse_ntt(plaintext.poly)
    inc = coeff.context.moduli[0] - t
    row = coeff.data[..., :1, :]
    out = torch.where(row >= (t + 1) // 2, row - inc, row)
    return Plaintext(context, PolyRq(out, context.plaintext_context, COEFF))


# ---------------------------------------------------------------------------
# Encryption
# ---------------------------------------------------------------------------


def encrypt_zero(
    context: BfvContext,
    secret_key: SecretKey,
    seed: bytes | None = None,
    err_rng=None,
    poly_context: PolyContext | None = None,
) -> Ciphertext:
    """c = (-(a*s + e), a) with `a` expanded from a retained seed
    (reference Bfv+Encrypt.swift:150-181)."""
    ct_ctx = poly_context or context.ciphertext_context
    seed = seed if seed is not None else os.urandom(SEED_BYTES)
    a_vals = sampling.sample_uniform(nist_aes128_ctr(seed), list(ct_ctx.moduli), ct_ctx.degree)
    a = PolyRq.from_values(a_vals, ct_ctx, EVAL)

    err_rng = err_rng or SystemRng()
    e_vals = sampling.sample_centered_binomial(
        err_rng, list(ct_ctx.moduli), ct_ctx.degree, context.params.error_std_dev.value
    )
    e = PolyRq.from_values(e_vals, ct_ctx, COEFF)

    a_s = polymod.mul_poly_rows(a, secret_key.poly.data)
    c0 = polymod.neg(polymod.add(polymod.inverse_ntt(a_s), e))
    return Ciphertext(context, [c0, polymod.inverse_ntt(a)], correction_factor=1, seed=seed)


def _plaintext_translate(ct: Ciphertext, pt: Plaintext, subtract: bool) -> Ciphertext:
    """c0 +-= round(Q/t * m): Delta-scaling with rounding correction
    (reference Bfv+Encrypt.swift:75-139)."""
    if ct.correction_factor != 1:
        raise errors.InvalidCorrectionFactor(str(ct.correction_factor))
    if ct.fmt != COEFF or pt.poly.fmt != COEFF:
        raise errors.InvalidFormat("plaintext translate requires Coeff")
    context = ct.context
    tool = context.get_rns_tool(ct.moduli_count)
    ct_ctx = ct.polys[0].context
    t = context.plaintext_modulus
    m = pt.poly.data  # [..., 1, N] values < t
    # adjust = floor((qModT * m + tThreshold) / t) < t
    if ma.is_wide(t):
        # qModT * m needs up to 2 log2(t) bits: a (hi, lo) pair, hi < t
        hi, lo = wide.mul_wide(m, tool.q_mod_t % t)
        lo = lo + tool.t_threshold
        adjust = wide.divmod_pair(hi + (lo >> 62), lo & wide.M62, t)[0]
    else:
        adjust = torch.div(m * (tool.q_mod_t % t) + tool.t_threshold, t, rounding_mode="floor")
    q = ct_ctx.q_col
    total = ma.add_mod(ma.mul_mod(m, ct_ctx.column(tool.q_div_t), q, bound=t), adjust, q)
    op = ma.sub_mod if subtract else ma.add_mod
    new_c0 = PolyRq(op(ct.polys[0].data, total, q), ct_ctx, COEFF)
    return Ciphertext(context, [new_c0] + ct.polys[1:], ct.correction_factor, None)


def encrypt(pt: Plaintext, secret_key: SecretKey, seed: bytes | None = None, err_rng=None) -> Ciphertext:
    ct = encrypt_zero(pt.context, secret_key, seed=seed, err_rng=err_rng)
    out = _plaintext_translate(ct, pt, subtract=False)
    out.seed = ct.seed
    return out


# ---------------------------------------------------------------------------
# Decryption
# ---------------------------------------------------------------------------


def _dot_product_with_key(ct: Ciphertext, secret_key: SecretKey) -> PolyRq:
    """sum_i c_i * s^i in Eval, then inverse NTT
    (reference Bfv+Decrypt.swift:188-204)."""
    polys = ct.polys
    ct_ctx = polys[0].context
    L = len(ct_ctx.moduli)
    if ct.fmt == COEFF:
        polys = [polymod.forward_ntt(p) for p in polys]
    sk = PolyRq(secret_key.poly.data[..., :L, :], ct_ctx, EVAL)
    acc = polys[0]
    sk_power = sk
    for idx, ci in enumerate(polys[1:]):
        acc = polymod.add(acc, polymod.mul_eval(ci, sk_power))
        if idx != len(polys) - 2:
            sk_power = polymod.mul_eval(sk_power, sk)
    return polymod.inverse_ntt(acc)


def noise_budget(ct: Ciphertext, secret_key: SecretKey) -> float:
    """log2(Q / (2 |v*t|_inf)) with a host CRT composition
    (reference Bfv+Decrypt.swift:116-174). Secret-leaking diagnostic. A
    ciphertext with batch axes gets the smallest budget of its batch."""
    dot = _dot_product_with_key(ct, secret_key)
    L = len(dot.moduli)
    vt = polymod.mul_scalar_rows(dot, [ct.context.plaintext_modulus] * L)
    tool = ct.context.get_rns_tool(L)
    Q = dot.context.q_product
    q_div_2 = (Q + 1) >> 1
    rows = np.moveaxis(vt.to_values(), -2, 0).reshape(L, -1)  # [L, batch * N]
    norm = 0
    for c in tool.crt_compose(rows):
        c = int(c)
        norm = max(norm, Q - c if c > q_div_2 else c)
    if norm == 0:
        return float("inf")
    return math.log2(Q / (2 * norm))


def decrypt(ct: Ciphertext, secret_key: SecretKey) -> Plaintext:
    context = ct.context
    t = context.plaintext_modulus
    dot = _dot_product_with_key(ct, secret_key)
    scaling = nt.inverse_mod(ct.correction_factor % t, t)
    tool = context.get_rns_tool(len(dot.moduli))
    out = tool.scale_and_round(dot.data, scaling)
    return Plaintext(context, PolyRq(out, context.plaintext_context, COEFF))


# ---------------------------------------------------------------------------
# Ciphertext ops
# ---------------------------------------------------------------------------


def _check_ct_compat(a: Ciphertext, b: Ciphertext):
    if a.context is not b.context:
        raise errors.IncompatibleContexts("different BFV contexts")
    if a.correction_factor != b.correction_factor:
        raise errors.InvalidCorrectionFactor(
            f"{a.correction_factor} vs {b.correction_factor}"
        )
    if len(a.polys) != len(b.polys):
        raise errors.InvalidCiphertext("different poly counts")


def ct_add(a: Ciphertext, b: Ciphertext) -> Ciphertext:
    _check_ct_compat(a, b)
    return Ciphertext(
        a.context, [polymod.add(x, y) for x, y in zip(a.polys, b.polys)], a.correction_factor
    )


def ct_sub(a: Ciphertext, b: Ciphertext) -> Ciphertext:
    _check_ct_compat(a, b)
    return Ciphertext(
        a.context, [polymod.sub(x, y) for x, y in zip(a.polys, b.polys)], a.correction_factor
    )


def ct_neg(a: Ciphertext) -> Ciphertext:
    return Ciphertext(a.context, [polymod.neg(p) for p in a.polys], a.correction_factor)


def ct_add_pt(a: Ciphertext, pt: Plaintext) -> Ciphertext:
    return _plaintext_translate(a, pt, subtract=False)


def ct_sub_pt(a: Ciphertext, pt: Plaintext) -> Ciphertext:
    return _plaintext_translate(a, pt, subtract=True)


def ct_mul_pt(a: Ciphertext, pt: Plaintext) -> Ciphertext:
    """Eval ciphertext x Eval plaintext, pointwise
    (reference Bfv.swift mulAssign(_:_:EvalPlaintext))."""
    if a.fmt != EVAL or pt.poly.fmt != EVAL:
        raise errors.InvalidFormat("ct*pt requires Eval formats")
    if pt.poly.context is not a.polys[0].context:
        raise errors.IncompatibleContexts("plaintext context mismatch")
    return Ciphertext(a.context, [polymod.mul_eval(p, pt.poly) for p in a.polys], a.correction_factor)


def is_transparent(a: Ciphertext) -> bool:
    """All polys except the first are zero (reference Bfv+Encrypt.swift:48-62)."""
    return not any(bool(torch.any(p.data != 0)) for p in a.polys[1:])


def ct_to_eval(a: Ciphertext) -> Ciphertext:
    if a.fmt == EVAL:
        return a
    return Ciphertext(
        a.context, [polymod.forward_ntt(p) for p in a.polys], a.correction_factor, a.seed
    )


def ct_to_coeff(a: Ciphertext) -> Ciphertext:
    if a.fmt == COEFF:
        return a
    return Ciphertext(
        a.context, [polymod.inverse_ntt(p) for p in a.polys], a.correction_factor, a.seed
    )


def mod_switch_down(a: Ciphertext) -> Ciphertext:
    """Drop the last ciphertext modulus (reference Bfv.swift:163-171)."""
    if a.fmt != COEFF:
        raise errors.InvalidFormat("modSwitchDown requires Coeff")
    if a.moduli_count < 2:
        raise errors.InvalidCiphertext("cannot drop below one modulus")
    return Ciphertext(
        a.context, [polymod.divide_and_round_q_last(p) for p in a.polys], a.correction_factor
    )


def mod_switch_down_to_single(a: Ciphertext) -> Ciphertext:
    while a.moduli_count > 1:
        a = mod_switch_down(a)
    return a


# ---------------------------------------------------------------------------
# Ciphertext-ciphertext multiply (BEHZ, eprint 2016/510)
# ---------------------------------------------------------------------------


def _compute_behz_polys(ct: Ciphertext) -> list[PolyRq]:
    """Lift each poly to [q, B_sk] and NTT (reference Bfv+Multiply.swift:51-57)."""
    tool = ct.context.get_rns_tool(ct.moduli_count)
    lifted = tool.lift_q_to_qbsk(ct.stacked())  # one lift and NTT for all polys
    ev = polymod.forward_ntt(PolyRq(lifted, tool.q_bsk_context, COEFF))
    return [PolyRq(ev.data[..., p, :, :], tool.q_bsk_context, EVAL) for p in range(len(ct.polys))]


def multiply_without_scaling(a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """Tensor product in the extended base (Bfv+Multiply.swift:63-85)."""
    if a.context is not b.context:
        raise errors.IncompatibleContexts("different contexts")
    if len(a.polys) != 2 or len(b.polys) != 2:
        raise errors.InvalidCiphertext("multiply requires 2-poly ciphertexts")
    if a.correction_factor != 1 or b.correction_factor != 1:
        raise errors.InvalidCorrectionFactor("multiply requires correction factor 1")
    if a.fmt != COEFF or b.fmt != COEFF:
        raise errors.InvalidFormat("multiply requires canonical (Coeff) ciphertexts")
    la, lb = _compute_behz_polys(a), _compute_behz_polys(b)
    p0 = polymod.mul_eval(la[0], lb[0])
    p1 = polymod.add(polymod.mul_eval(la[0], lb[1]), polymod.mul_eval(la[1], lb[0]))
    p2 = polymod.mul_eval(la[1], lb[1])
    return Ciphertext(a.context, [p0, p1, p2], correction_factor=1)


def drop_extended_base(ct: Ciphertext) -> Ciphertext:
    """[q, B_sk] -> q: multiply by t, inverse NTT, BEHZ floor
    (Bfv+Multiply.swift:31-48)."""
    count = ct.moduli_count
    if count % 2 != 1 or count < 3:
        raise errors.InvalidCiphertext("extended-base ciphertext must have odd moduli count >= 3")
    tool = ct.context.get_rns_tool((count - 1) // 2)
    ext_ctx = ct.polys[0].context
    t = ct.context.plaintext_modulus
    scaled = polymod.mul_scalar_rows(PolyRq(ct.stacked(), ext_ctx, EVAL), [t] * count)
    coeff = polymod.inverse_ntt(scaled)  # one inverse NTT for all polys
    floored = tool.floor_qbsk_to_q(coeff.data)
    return Ciphertext.from_stacked(
        ct.context, floored, tool.input_context, COEFF, ct.correction_factor
    )


def ct_mul(a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """Full BEHZ ct*ct, yielding a 3-poly ciphertext (relinearize to get 2)."""
    return drop_extended_base(multiply_without_scaling(a, b))


def inner_product_ct_ct_stacked(lhs: Ciphertext, rhs: Ciphertext, axis: int = -3) -> Ciphertext:
    """sum over `axis` of lhs_k * rhs_k for ciphertexts whose polys carry a
    K axis at `axis` of their [..., K, L, N] data: the products accumulate
    in the extended [q, B_sk] base with one scaling/floor at the end
    (reference Bfv.swift:236-651)."""
    prod = multiply_without_scaling(lhs, rhs)
    ext_ctx = prod.polys[0].context
    q = ext_ctx.q_col
    polys = []
    for p in prod.polys:
        polys.append(PolyRq(ma.sum_mod(p.data, q, axis), ext_ctx, EVAL))
    return drop_extended_base(Ciphertext(prod.context, polys, prod.correction_factor))


def inner_product_ct_ct(lhs: list[Ciphertext], rhs: list[Ciphertext]) -> Ciphertext:
    """sum_i lhs_i * rhs_i (list form of inner_product_ct_ct_stacked)."""
    if not lhs or len(lhs) != len(rhs):
        raise errors.InvalidCiphertext("inner product needs equal, non-empty lists")

    def stack(cts):
        polys = [
            PolyRq(torch.stack([c.polys[p].data for c in cts], dim=-3),
                   cts[0].polys[p].context, cts[0].fmt)
            for p in range(len(cts[0].polys))
        ]
        return Ciphertext(cts[0].context, polys, cts[0].correction_factor)

    return inner_product_ct_ct_stacked(stack(lhs), stack(rhs))


def inner_product_ct_pt(cts: list[Ciphertext], pts: list) -> Ciphertext:
    """sum_i ct_i * pt_i over Eval ciphertexts and Eval plaintexts, lazily
    accumulated in int64 (reference Bfv.swift:236-651). pts entries may be
    None (skipped zero plaintexts, as in PIR processed databases)."""
    pairs = [(c, p) for c, p in zip(cts, pts) if p is not None]
    if not pairs:
        raise errors.InvalidCiphertext("empty inner product")
    first = pairs[0][0]
    ct_ctx = pairs[0][1].poly.context
    cap = ct_ctx.max_signed_lazy_product_count()
    out = []
    for comp in range(len(first.polys)):
        terms = ((c.polys[comp].data, p.poly.data) for c, p in pairs)
        out.append(PolyRq(ma.sum_products_mod(terms, ct_ctx.q_col, cap), ct_ctx, EVAL))
    return Ciphertext(first.context, out, first.correction_factor)


# ---------------------------------------------------------------------------
# Key switching: relinearize / Galois / rotations
# ---------------------------------------------------------------------------


def relinearize(ct: Ciphertext, evaluation_key) -> Ciphertext:
    """3 -> 2 polys via the relinearization key (reference Bfv.swift:201-219)."""
    from . import keys as keysmod

    if len(ct.polys) != 3:
        raise errors.InvalidCiphertext("relinearize requires 3 polys")
    if ct.correction_factor != 1:
        raise errors.InvalidCorrectionFactor(str(ct.correction_factor))
    if evaluation_key.relinearization_key is None:
        raise errors.MissingRelinearizationKey()
    u0, u1 = keysmod.compute_key_switching_update(
        ct.context, ct.polys[2], evaluation_key.relinearization_key.key_switch_key
    )
    return Ciphertext(
        ct.context, [polymod.add(ct.polys[0], u0), polymod.add(ct.polys[1], u1)],
        ct.correction_factor,
    )


def apply_galois(ct: Ciphertext, element: int, evaluation_key) -> Ciphertext:
    """f(x) -> f(x^element) with key switching (reference Bfv.swift:174-198)."""
    from . import keys as keysmod

    if len(ct.polys) != 2:
        raise errors.InvalidCiphertext("applyGalois requires 2 polys")
    if ct.correction_factor != 1:
        raise errors.InvalidCorrectionFactor(str(ct.correction_factor))
    if ct.fmt != COEFF:
        raise errors.InvalidFormat("applyGalois requires canonical (Coeff) format")
    if evaluation_key.galois_key is None or element not in evaluation_key.galois_key.keys:
        raise errors.MissingGaloisKey(str(element))
    ct_ctx = ct.polys[0].context
    perm = galoismod.apply_galois_coeff(ct.stacked(), ct_ctx.q_col, element)
    u0, u1 = keysmod.compute_key_switching_update(
        ct.context, PolyRq(perm[..., 1, :, :], ct_ctx, COEFF),
        evaluation_key.galois_key.keys[element],
    )
    c0 = polymod.add(PolyRq(perm[..., 0, :, :], ct_ctx, COEFF), u0)
    return Ciphertext(ct.context, [c0, u1], ct.correction_factor)


def rotate_columns(ct: Ciphertext, step: int, evaluation_key) -> Ciphertext:
    """SIMD column rotation (reference HeScheme.swift:1463-1470):
    rotate_columns(ct, 1, ek) moves every slot of each row right by one."""
    return apply_galois(ct, galoismod.rotating_columns_element(step, ct.context.degree), evaluation_key)


def swap_rows(ct: Ciphertext, evaluation_key) -> Ciphertext:
    """SIMD row swap (reference HeScheme.swift:1472-1477)."""
    return apply_galois(ct, galoismod.swapping_rows_element(ct.context.degree), evaluation_key)


def ct_mul_relin(a: Ciphertext, b: Ciphertext, evaluation_key) -> Ciphertext:
    return relinearize(ct_mul(a, b), evaluation_key)


def multiply_power_of_x(ct: Ciphertext, power: int) -> Ciphertext:
    """Negacyclic shift of every poly (reference HeScheme.swift:1075)."""
    return Ciphertext(
        ct.context,
        [polymod.multiply_power_of_x(p, power) for p in ct.polys],
        ct.correction_factor,
    )
