"""Serialization: polynomials, seeded and full ciphertexts, LSB skipping,
plaintexts and keys, byte for byte as she_tpu/io/serialize.py writes them.

Wire format of the reference:
* CoefficientPacking: big-endian bitstream of (bitsPerCoeff - skipLSBs)-bit
  fields (io/coeffs.py; CoefficientPacking.swift:34-217).
* Poly vectors: little-endian uint16 poly count, then per poly the packed
  RNS rows at ceil(log2 q_i) bits (Serialize.swift:20-100,
  PolyRq+Serialize.swift:64-100).
* Ciphertexts: seeded (poly0 and the 32-byte AES-CTR-DRBG seed of a fresh
  2-poly ciphertext, from which `a` re-expands) or full (polys, skipLSBs,
  correction factor) (SerializedCiphertext.swift:22-160).

Packing runs on the host with numpy over whole rows. A seeded ciphertext's
`a` is sampled on the host from its seed and brought to Coeff form on the
context's device; `deserialize_ciphertexts` does that for many ciphertexts
with their generators in lockstep, one upload and one inverse NTT.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import errors
from ..bfv import bfv as bfvmod
from ..bfv import keys as keysmod
from ..core import poly as polymod
from ..core.context import PolyContext
from ..core.poly import COEFF, EVAL, PolyRq
from ..rng import sampling
from .coeffs import (
    bytes_to_coefficients,
    ceil_log2,
    coefficients_to_bytes,
    coefficients_to_bytes_byte_count,
    floor_log2,
)

# -- polys -------------------------------------------------------------------


def poly_serialization_byte_count(context: PolyContext, skip_lsbs: int = 0) -> int:
    return sum(
        coefficients_to_bytes_byte_count(context.degree, ceil_log2(q), skip_lsbs)
        for q in context.moduli
    )


def _serialize_rows(vals: np.ndarray, moduli, skip_lsbs: int) -> bytes:
    return b"".join(
        coefficients_to_bytes(vals[i], ceil_log2(q), skip_lsbs) for i, q in enumerate(moduli)
    )


def serialize_poly(p: PolyRq, skip_lsbs: int = 0) -> bytes:
    return _serialize_rows(p.to_values(), p.context.moduli, skip_lsbs)


def _deserialize_rows(data: bytes, context: PolyContext, skip_lsbs: int) -> np.ndarray:
    """Packed rows -> int64 [L, N] residues."""
    vals = np.zeros((len(context.moduli), context.degree), dtype=np.int64)
    offset = 0
    for i, q in enumerate(context.moduli):
        nb = coefficients_to_bytes_byte_count(context.degree, ceil_log2(q), skip_lsbs)
        if offset + nb > len(data):
            raise errors.SerializationError("buffer too short for poly")
        coeffs = bytes_to_coefficients(data[offset : offset + nb], ceil_log2(q), False, skip_lsbs)
        vals[i] = coeffs[: context.degree]
        offset += nb
    return vals


def deserialize_poly(data: bytes, context: PolyContext, fmt: str, skip_lsbs: int = 0) -> PolyRq:
    return PolyRq.from_values(_deserialize_rows(data, context, skip_lsbs), context, fmt)


def serialize_polys(polys: list, skip_lsbs: list | None = None) -> bytes:
    """uint16-LE poly count + packed polys (Serialize.swift:20-68)."""
    skip_lsbs = skip_lsbs or [0] * len(polys)
    out = [len(polys).to_bytes(2, "little")]
    for p, s in zip(polys, skip_lsbs):
        out.append(serialize_poly(p, s))
    return b"".join(out)


def deserialize_polys(data: bytes, context: PolyContext, fmt: str, skip_lsbs: list | None = None) -> list:
    count = int.from_bytes(data[:2], "little")
    skip_lsbs = skip_lsbs or [0] * count
    offset = 2
    polys = []
    for i in range(count):
        nb = poly_serialization_byte_count(context, skip_lsbs[i])
        polys.append(deserialize_poly(data[offset : offset + nb], context, fmt, skip_lsbs[i]))
        offset += nb
    return polys


# -- ciphertexts -----------------------------------------------------------------


@dataclass(frozen=True)
class SerializedCiphertext:
    """kind: 'seeded' (poly0 + seed) or 'full' (polys + skipLSBs + correction)."""

    kind: str
    polys: bytes
    seed: bytes = b""
    skip_lsbs: tuple = ()
    correction_factor: int = 1


def skip_lsbs_for_decryption(ct) -> list:
    """Per-poly LSB drop counts for decryption-only serialization
    (reference Bfv+Decrypt.swift:51-109, eprint 2022/207 Sec. 5.2 with
    corrections; z-score 8)."""
    if ct.moduli_count != 1:
        return [0] * len(ct.polys)
    params = ct.context.params
    q0 = params.coefficient_moduli[0]
    t = params.plaintext_modulus
    l_prime = floor_log2(q0 // t) - 3 if q0 >= 2 * t else 0
    poly0 = max(l_prime, 0)
    tmp = int(8.0 * math.sqrt(2.0 * params.poly_degree / 9.0))
    poly1 = l_prime - (0 if tmp == 0 else ceil_log2(tmp))
    if poly1 <= 1:
        poly0 = max(l_prime + 1, 0)
        poly1 = 0
    return [poly0, poly1]


def serialize_ciphertext(ct, for_decryption: bool = False, indices: list | None = None) -> SerializedCiphertext:
    """Seeded form when the fresh seed is retained; otherwise the full form
    with optional LSB skipping and index masking
    (SerializedCiphertext.swift:76-160)."""
    if indices is not None:
        if ct.fmt != COEFF:
            raise errors.InvalidFormat("index masking requires Coeff")
        p0 = ct.polys[0]
        for idx in indices:
            if not 0 <= idx < p0.degree:
                raise errors.SerializationError(f"invalid coefficient index {idx}")
        keep = torch.zeros(p0.degree, dtype=torch.bool, device=p0.data.device)
        keep[list(indices)] = True
        masked0 = PolyRq(torch.where(keep, p0.data, torch.zeros_like(p0.data)), p0.context, COEFF)
        ct = bfvmod.Ciphertext(ct.context, [masked0] + ct.polys[1:], ct.correction_factor, ct.seed)

    if ct.seed and len(ct.polys) == 2:
        return SerializedCiphertext(kind="seeded", polys=serialize_poly(ct.polys[0]), seed=ct.seed)
    if for_decryption and ct.fmt == COEFF:
        skips = skip_lsbs_for_decryption(ct)
    else:
        skips = [0] * len(ct.polys)
    return SerializedCiphertext(
        kind="full",
        polys=serialize_polys(ct.polys, skips),
        skip_lsbs=tuple(skips),
        correction_factor=ct.correction_factor,
    )


def deserialize_ciphertexts(serialized: list, context, fmt: str, moduli_count: int | None = None) -> list:
    """Many ciphertexts at once: the `a` polys of all seeded ones are
    sampled from their seeds on the host with the generators in lockstep
    (sampling.sample_uniform_many), uploaded together and, for Coeff,
    brought out of Eval form by one batched inverse NTT on the device."""
    c = moduli_count or len(context.ciphertext_context.moduli)
    poly_ctx = context.secret_key_context.get_context(c)
    out = [None] * len(serialized)
    seeded = [i for i, s in enumerate(serialized) if s.kind == "seeded"]
    if seeded:
        seeds = [serialized[i].seed for i in seeded]
        a_vals = sampling.sample_uniform_many(seeds, list(poly_ctx.moduli), poly_ctx.degree)
        a_all = PolyRq.from_values(a_vals, poly_ctx, EVAL)
        if fmt == COEFF:
            a_all = polymod.inverse_ntt(a_all)
        for j, i in enumerate(seeded):
            p0 = deserialize_poly(serialized[i].polys, poly_ctx, fmt)
            a = PolyRq(a_all.data[j], poly_ctx, a_all.fmt)
            out[i] = bfvmod.Ciphertext(context, [p0, a], 1, serialized[i].seed)
    for i, s in enumerate(serialized):
        if s.kind != "seeded":
            polys = deserialize_polys(s.polys, poly_ctx, fmt, list(s.skip_lsbs) or None)
            out[i] = bfvmod.Ciphertext(context, polys, s.correction_factor, None)
    return out


def deserialize_ciphertext(serialized: SerializedCiphertext, context, fmt: str, moduli_count: int | None = None):
    """fmt: format of the serialized polys ('coeff' or 'eval')."""
    return deserialize_ciphertexts([serialized], context, fmt, moduli_count)[0]


# -- plaintexts and keys -----------------------------------------------------------


def serialize_plaintext(pt) -> bytes:
    return serialize_poly(pt.poly)


def deserialize_plaintext(data: bytes, context, fmt: str = COEFF, moduli_count: int | None = None):
    if fmt == COEFF:
        poly_ctx = context.plaintext_context
    else:
        c = moduli_count or len(context.ciphertext_context.moduli)
        poly_ctx = context.ciphertext_context.get_context(c)
    return bfvmod.Plaintext(context, deserialize_poly(data, poly_ctx, fmt))


def serialize_secret_key(sk) -> bytes:
    return serialize_polys([sk.poly])


def deserialize_secret_key(data: bytes, context):
    polys = deserialize_polys(data, context.secret_key_context, EVAL)
    return bfvmod.SecretKey(polys[0])


def serialize_key_switch_key(ksk) -> list:
    return [serialize_ciphertext(ct) for ct in ksk.ciphertexts]


def deserialize_key_switch_key(serialized: list, context):
    count = len(context.secret_key_context.moduli)
    return keysmod.KeySwitchKey(deserialize_ciphertexts(serialized, context, EVAL, moduli_count=count))


def serialize_evaluation_key(ek) -> dict:
    out = {"galois": None, "relin": None}
    if ek.galois_key is not None:
        out["galois"] = {el: serialize_key_switch_key(k) for el, k in ek.galois_key.keys.items()}
    if ek.relinearization_key is not None:
        out["relin"] = serialize_key_switch_key(ek.relinearization_key.key_switch_key)
    return out


def deserialize_evaluation_key(serialized: dict, context):
    galois = None
    if serialized.get("galois"):
        galois = keysmod.GaloisKey(
            {el: deserialize_key_switch_key(v, context) for el, v in serialized["galois"].items()}
        )
    relin = None
    if serialized.get("relin"):
        relin = keysmod.RelinearizationKey(deserialize_key_switch_key(serialized["relin"], context))
    return keysmod.EvaluationKey(galois, relin)
