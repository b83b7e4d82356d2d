"""NoOpScheme: identity "encryption" for testing generic plumbing cheaply.

The port of she_tpu/bfv/noop.py (reference NoOpScheme.swift:31-368).
Ciphertexts wrap the plaintext polynomial (mod t) directly; every
homomorphic op is plain mod-t polynomial arithmetic on the plaintext's
device. Useful for exercising application layers (PIR / PNNS protocol
flow) without cryptographic cost.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import poly as polymod
from ..core.poly import COEFF, EVAL, PolyRq
from ..ops import galois as galoismod
from ..utils import nt
from . import bfv as bfvmod

FRESH_CIPHERTEXT_POLY_COUNT = 1
MIN_NOISE_BUDGET = float("-inf")


@dataclass
class NoOpCiphertext:
    context: bfvmod.BfvContext
    poly: PolyRq  # over the plaintext context


def generate_secret_key(context, rng=None) -> bfvmod.SecretKey:
    return bfvmod.SecretKey(PolyRq.zero(context.plaintext_context, EVAL))


def encrypt(pt: bfvmod.Plaintext, secret_key=None) -> NoOpCiphertext:
    return NoOpCiphertext(pt.context, pt.poly)


def decrypt(ct: NoOpCiphertext, secret_key=None) -> bfvmod.Plaintext:
    return bfvmod.Plaintext(ct.context, ct.poly)


def ct_add(a: NoOpCiphertext, b: NoOpCiphertext) -> NoOpCiphertext:
    return NoOpCiphertext(a.context, polymod.add(a.poly, b.poly))


def ct_sub(a: NoOpCiphertext, b: NoOpCiphertext) -> NoOpCiphertext:
    return NoOpCiphertext(a.context, polymod.sub(a.poly, b.poly))


def ct_neg(a: NoOpCiphertext) -> NoOpCiphertext:
    return NoOpCiphertext(a.context, polymod.neg(a.poly))


def ct_add_pt(a: NoOpCiphertext, pt: bfvmod.Plaintext) -> NoOpCiphertext:
    return NoOpCiphertext(a.context, polymod.add(a.poly, pt.poly))


def ct_mul(a: NoOpCiphertext, b: NoOpCiphertext) -> NoOpCiphertext:
    """Negacyclic product mod t: through the mod-t NTT where t is
    NTT-friendly for N, else schoolbook on the host."""
    ctx = a.poly.context
    if all(nt.is_ntt_modulus(q, ctx.degree) for q in ctx.moduli):
        prod = polymod.mul_eval(polymod.forward_ntt(a.poly), polymod.forward_ntt(b.poly))
        return NoOpCiphertext(a.context, polymod.inverse_ntt(prod))
    t, n = ctx.moduli[0], ctx.degree
    av = [int(v) for v in a.poly.to_values()[0]]
    bv = np.array([int(v) for v in b.poly.to_values()[0]], dtype=object)
    out = np.zeros(n, dtype=object)
    for i, ai in enumerate(av):
        # x^i * b: b shifted up by i, the wrapped part negated
        out[i:] += ai * bv[: n - i]
        out[:i] -= ai * bv[n - i :]
    return NoOpCiphertext(a.context, PolyRq.from_values((out % t)[None, :], ctx, COEFF))


def apply_galois(ct: NoOpCiphertext, element: int, evaluation_key=None) -> NoOpCiphertext:
    ctx = ct.poly.context
    out = galoismod.apply_galois_coeff(ct.poly.data, ctx.q_col, element)
    return NoOpCiphertext(ct.context, PolyRq(out, ctx, COEFF))


def noise_budget(ct: NoOpCiphertext, secret_key=None) -> float:
    return float("inf")
