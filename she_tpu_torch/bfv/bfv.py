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

from .. import errors, trace
from ..core import poly as polymod
from ..core import rns as rnsmod
from ..core.context import PolyContext, get_poly_context
from ..core.poly import COEFF, EVAL, PolyRq
from ..device import resolve_device
from ..ops import behz, dim0_mac, key_switch
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


def _mod_switch(a: Ciphertext, target: int) -> Ciphertext:
    """a (Coeff, over L > target moduli) down to its first `target` moduli:
    ops/key_switch.mod_switch over all its polys, read in place where they
    are equally spaced views of one tensor (stacked_view). Counted as
    mod_switch in the tracer's registry: on a CUDA card each launches
    mod_switch once, for every poly and every dropped modulus."""
    if a.fmt != COEFF:
        raise errors.InvalidFormat("modSwitchDown requires Coeff")
    if a.moduli_count < 2:
        raise errors.InvalidCiphertext("cannot drop below one modulus")
    ctx = a.poly_context()
    with trace.span("mod_switch"):
        data = key_switch.mod_switch(stacked_view(a), ctx, target)
    trace.count("mod_switch")
    return Ciphertext.from_stacked(a.context, data, ctx.get_context(target), COEFF, a.correction_factor)


def mod_switch_down(a: Ciphertext) -> Ciphertext:
    """Drop the last ciphertext modulus (reference Bfv.swift:163-171)."""
    return _mod_switch(a, a.moduli_count - 1)


def mod_switch_down_to_single(a: Ciphertext) -> Ciphertext:
    """Drop every ciphertext modulus but the first: mod_switch_down until
    one is left, as one mod switch of all the drops."""
    return a if a.moduli_count == 1 else _mod_switch(a, 1)


# ---------------------------------------------------------------------------
# Ciphertext-ciphertext multiply (BEHZ, eprint 2016/510)
# ---------------------------------------------------------------------------


def stack_in_place(datas: list, dim: int) -> torch.Tensor:
    """torch.stack(datas, dim) without its copy where the tensors are
    equally spaced views of one tensor with a contiguous last axis (a
    Ciphertext made by from_stacked, a processed database's plaintexts):
    a strided view that the kernels read in place. Otherwise the stacked
    copy."""
    first = datas[0]
    if len(datas) > 1 and first.dim() and first.stride(-1) == 1:
        step = datas[1].storage_offset() - first.storage_offset()
        ptr = first.untyped_storage().data_ptr()
        if step > 0 and all(d.untyped_storage().data_ptr() == ptr and d.dtype == first.dtype
                            and d.shape == first.shape and d.stride() == first.stride()
                            and d.storage_offset() == first.storage_offset() + i * step for i, d in enumerate(datas)):
            at = dim % (first.dim() + 1)
            return first.as_strided(first.shape[:at] + (len(datas),) + first.shape[at:],
                                    first.stride()[:at] + (step,) + first.stride()[at:])
    return torch.stack(datas, dim)


def stacked_view(ct: Ciphertext) -> torch.Tensor:
    """ct.stacked(), read in place where it can be (stack_in_place): the
    BEHZ kernels' operand."""
    return stack_in_place([p.data for p in ct.polys], -3)


def _lifted_eval(ct: Ciphertext, tool) -> torch.Tensor:
    """Lift each poly to [q, B_sk] and NTT (reference
    Bfv+Multiply.swift:51-57): [..., polys, L + L_bsk, N] Eval."""
    lifted = tool.lift_q_to_qbsk(stacked_view(ct))  # one lift and NTT for all polys
    return polymod.forward_ntt(PolyRq(lifted, tool.q_bsk_context, COEFF)).data


def tensor_product(lhs: Ciphertext, rhs: Ciphertext, axis: int | None = None, scale: int = 1) -> Ciphertext:
    """The tensor product in the extended base [q, B_sk] (reference
    Bfv+Multiply.swift:63-85): a 3-poly Eval ciphertext over [q, B_sk],
    summed over the K axis at `axis` of the polys' [..., K, L, N] data
    where one is given, each row times `scale` mod its modulus. On a CUDA
    card: two behz_lift launches, their forward NTTs and one
    behz_tensor_mac (ops/behz.py). Counted as behz.tensor_product in the
    tracer's registry."""
    if lhs.context is not rhs.context:
        raise errors.IncompatibleContexts("different contexts")
    if len(lhs.polys) != 2 or len(rhs.polys) != 2:
        raise errors.InvalidCiphertext("multiply requires 2-poly ciphertexts")
    if lhs.correction_factor != 1 or rhs.correction_factor != 1:
        raise errors.InvalidCorrectionFactor("multiply requires correction factor 1")
    if lhs.fmt != COEFF or rhs.fmt != COEFF:
        raise errors.InvalidFormat("multiply requires canonical (Coeff) ciphertexts")
    tool = lhs.context.get_rns_tool(lhs.moduli_count)
    ext_ctx = tool.q_bsk_context
    # the K axis of the stacked [..., K, polys, L, N] data
    stacked_axis = None if axis is None else (axis - 1 if axis < 0 else axis)
    with trace.span("behz.tensor_product"):
        out = behz.behz_tensor_mac(_lifted_eval(lhs, tool), _lifted_eval(rhs, tool), ext_ctx, scale, stacked_axis)
    trace.count("behz.tensor_product")
    return Ciphertext.from_stacked(lhs.context, out, ext_ctx, EVAL)


def multiply_without_scaling(a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """Tensor product in the extended base (Bfv+Multiply.swift:63-85)."""
    return tensor_product(a, b)


def drop_extended_base(ct: Ciphertext, scale: int | None = None) -> Ciphertext:
    """[q, B_sk] -> q: multiply by t, inverse NTT, BEHZ floor
    (Bfv+Multiply.swift:31-48). `scale` is the factor applied first: t by
    default, as she_tpu does; 1 for a product that tensor_product already
    scaled by t. The scale runs inside the floor (behz_floor), after the
    inverse NTT, which is linear mod each modulus: the same bits. Counted
    as behz.floor in the tracer's registry: on a CUDA card one behz_floor
    launch."""
    count = ct.moduli_count
    if count % 2 != 1 or count < 3:
        raise errors.InvalidCiphertext("extended-base ciphertext must have odd moduli count >= 3")
    tool = ct.context.get_rns_tool((count - 1) // 2)
    ext_ctx = ct.polys[0].context
    with trace.span("behz.floor"):
        coeff = polymod.inverse_ntt(PolyRq(stacked_view(ct), ext_ctx, EVAL))  # one inverse NTT for all polys
        floored = tool.floor_qbsk_to_q(coeff.data, ct.context.plaintext_modulus if scale is None else scale)
    trace.count("behz.floor")
    return Ciphertext.from_stacked(
        ct.context, floored, tool.input_context, COEFF, ct.correction_factor
    )


def ct_mul(a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """Full BEHZ ct*ct, yielding a 3-poly ciphertext (relinearize to get 2):
    the scale by t runs once, in the tensor product."""
    return drop_extended_base(tensor_product(a, b, scale=a.context.plaintext_modulus), scale=1)


def inner_product_ct_ct_stacked(lhs: Ciphertext, rhs: Ciphertext, axis: int = -3) -> Ciphertext:
    """sum over `axis` of lhs_k * rhs_k for ciphertexts whose polys carry a
    K axis at `axis` of their [..., K, L, N] data: the products accumulate
    in the extended [q, B_sk] base, scaled by t once, with one floor at
    the end (reference Bfv.swift:236-651)."""
    prod = tensor_product(lhs, rhs, axis, lhs.context.plaintext_modulus)
    return drop_extended_base(prod, scale=1)


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
    """sum_i ct_i * pt_i over Eval ciphertexts and Eval plaintexts
    (reference Bfv.swift:236-651). pts entries may be None (skipped zero
    plaintexts, as in PIR processed databases). The non-None pairs make
    two operands, the plaintexts [1, K, L, N] and each component of the
    ciphertexts [K, ..., L, N] (stack_in_place: no copy where they are
    rows of one tensor), and each component is one ops/dim0_mac: on the card the
    kernel of csrc/dim0_mac.cu, on the CPU the lazy multiply-add stream."""
    pairs = [(c, p) for c, p in zip(cts, pts) if p is not None]
    if not pairs:
        raise errors.InvalidCiphertext("empty inner product")
    first = pairs[0][0]
    ct_ctx = pairs[0][1].poly.context
    plain = stack_in_place([p.poly.data for _, p in pairs], 0).unsqueeze(0)
    out = []
    for comp in range(len(first.polys)):
        comps = stack_in_place([c.polys[comp].data for c, _ in pairs], 0)
        out.append(PolyRq(dim0_mac.dim0_mac(plain, comps, ct_ctx)[0], ct_ctx, EVAL))
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
    c0, c1, c2 = ct.polys
    if c2.fmt != COEFF:
        raise errors.InvalidFormat("key switch target must be Coeff")
    for p in (c0, c1):
        polymod.check_same(p, c2)
    with trace.span("relinearize"):
        out = keysmod.key_switch(
            ct.context, c2.data, evaluation_key.relinearization_key.key_switch_key, c0=c0.data, c1=c1.data
        )
    return Ciphertext.from_stacked(ct.context, out, c2.context, COEFF, ct.correction_factor)


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
    c0, c1 = ct.polys
    polymod.check_same(c0, c1)
    out = keysmod.key_switch(
        ct.context, c1.data, evaluation_key.galois_key.keys[element], element=element, c0=c0.data
    )
    return Ciphertext.from_stacked(ct.context, out, c1.context, COEFF, ct.correction_factor)


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
