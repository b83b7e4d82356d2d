"""Evaluation keys: hybrid key switching (alpha=1) with RNS decomposition.

The port of she_tpu/bfv/keys.py (reference Bfv+Keys.swift:14-209,
Keys.swift:19-283): one special key-switching modulus q_ks (the last
coefficient modulus); key-switch keys are seeded encryptions of 0 over the
full key-switching context with q_ks * currentKey folded into c0.

A key switch (`key_switch`) runs in the row-vectorized form of she_tpu's
_compute_key_switching_update_w32 as ops/key_switch.py's passes around two
batched NTTs: ks_digits reduces every decomposition digit (after the
Galois gather, where an element is given) mod every key-switching
modulus, ONE forward NTT, ks_mac multiplies them into the key with one
lazy MAC, ONE inverse NTT, and ks_finish drops q_ks and adds the result
into the ciphertext. On a CUDA card each pass is a hand-written kernel
(csrc/key_switch.cu). It is bit-identical to she_tpu's per-modulus
_compute_key_switching_update, and it works on a target with any leading
batch axes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .. import errors
from ..core import poly as polymod
from ..core.poly import COEFF, EVAL, PolyRq
from ..ops import galois as galoismod
from ..ops import key_switch as ks
from ..ops import modarith as ma
from ..ops import ntt as nttmod
from ..rng.ctr_drbg import SystemRng


@dataclass
class KeySwitchKey:
    """One 2-poly Eval ciphertext per decomposition modulus, over the full
    key-switching context {q_0..q_{L-1}, q_ks}."""

    ciphertexts: list  # list[Ciphertext] (Eval)
    _rows: dict = field(default_factory=dict, repr=False, compare=False)

    def key_rows(self, digits: int) -> torch.Tensor:
        """[digits, components, digits + 1, N]: for each decomposition digit
        j < `digits`, the key rows of the first `digits` moduli and of q_ks
        (the key lives over the top key-switching context, q_ks last)."""
        if digits not in self._rows:
            per_digit = []
            for ct in self.ciphertexts[:digits]:
                comps = [torch.cat((p.data[:digits], p.data[-1:]), dim=0) for p in ct.polys]
                per_digit.append(torch.stack(comps))
            self._rows[digits] = torch.stack(per_digit)
        return self._rows[digits]


@dataclass
class GaloisKey:
    keys: dict  # element -> KeySwitchKey


@dataclass
class RelinearizationKey:
    key_switch_key: KeySwitchKey


@dataclass
class EvaluationKey:
    galois_key: GaloisKey | None = None
    relinearization_key: RelinearizationKey | None = None


@dataclass(frozen=True)
class EvaluationKeyConfig:
    """Reference Keys.swift:222-283."""

    galois_elements: tuple[int, ...] = ()
    has_relinearization_key: bool = False

    def union(self, other: "EvaluationKeyConfig") -> "EvaluationKeyConfig":
        return EvaluationKeyConfig(
            tuple(sorted(set(self.galois_elements) | set(other.galois_elements))),
            self.has_relinearization_key or other.has_relinearization_key,
        )

    def contains(self, other: "EvaluationKeyConfig") -> bool:
        return set(other.galois_elements) <= set(self.galois_elements) and (
            self.has_relinearization_key or not other.has_relinearization_key
        )

    @property
    def key_count(self) -> int:
        return len(self.galois_elements) + (1 if self.has_relinearization_key else 0)


def generate_key_switch_key(context, current_key: torch.Tensor, target_key, err_rng=None) -> KeySwitchKey:
    """Key-switch key from `current_key` (Eval [>= L_top, N] over the
    secret-key moduli) to the target secret key (reference
    Bfv+Keys.swift:69-103)."""
    from . import bfv as bfvmod

    if not context.supports_evaluation_key:
        raise errors.HeError("parameters do not support evaluation keys")
    ks_ctx = context.key_switching_contexts[-1]
    q_ks = context.key_switch_modulus
    ciphers = []
    for i, qi in enumerate(context.ciphertext_context.moduli):
        ct = bfvmod.ct_to_eval(
            bfvmod.encrypt_zero(context, target_key, err_rng=err_rng, poly_context=ks_ctx)
        )
        # c0.row[i] += (q_ks mod q_i) * currentKey.row[i] mod q_i
        c0 = ct.polys[0].data.clone()
        c0[i] = ma.add_mod(c0[i], ma.mul_mod(current_key[i], q_ks % qi, qi), qi)
        ct.polys[0] = PolyRq(c0, ks_ctx, EVAL)
        ct.seed = None
        ciphers.append(ct)
    return KeySwitchKey(ciphers)


def generate_relinearization_key(context, secret_key, err_rng=None) -> RelinearizationKey:
    s2 = polymod.mul_eval(secret_key.poly, secret_key.poly)
    return RelinearizationKey(generate_key_switch_key(context, s2.data, secret_key, err_rng))


def generate_galois_key(context, secret_key, elements, err_rng=None) -> GaloisKey:
    keys = {}
    for element in elements:
        if element in keys:
            continue
        switched = galoismod.apply_galois_eval(secret_key.poly.data, element)
        keys[element] = generate_key_switch_key(context, switched, secret_key, err_rng)
    return GaloisKey(keys)


def generate_evaluation_key(context, config: EvaluationKeyConfig, secret_key, err_rng=None) -> EvaluationKey:
    err_rng = err_rng or SystemRng()
    galois = (
        generate_galois_key(context, secret_key, config.galois_elements, err_rng)
        if config.galois_elements
        else None
    )
    relin = (
        generate_relinearization_key(context, secret_key, err_rng)
        if config.has_relinearization_key
        else None
    )
    return EvaluationKey(galois, relin)


# key switches run since the last reset: on a CUDA card each launches
# ks_digits, ks_mac and ks_finish once
switches = {"key_switch": 0}


def reset_switches() -> None:
    for k in switches:
        switches[k] = 0


def key_switch(context, target: torch.Tensor, ksk: KeySwitchKey, element: int | None = None, index=None,
               c0=None, c1=None) -> torch.Tensor:
    """Switch the key of `target`, int64 [..., L_t, N] Coeff data over the
    first L_t ciphertext moduli: with `element`, of its Galois image.
    Returns [..., 2, L_t, N] Coeff: the update (u0, u1) alone, with g(c0)
    added into u0 (c0 and `element` given: apply_galois), or with c0 and
    c1 added into u0 and u1 (both given, no element: relinearize). `index` gathers axis 0 of target, c0 and c1 (the
    expansion's slot pool, read in place). Reference
    Bfv+Keys.swift:123-208."""
    L_t = target.shape[-2]
    ks_ctx = context.key_switching_contexts[L_t - 1]
    digits = ks.ks_digits(target, ks_ctx, element, index)  # [..., L_t, L_ks, N]
    fwd = nttmod.forward_ntt(digits, ks_ctx.ntt_tables)
    acc = ks.ks_mac(fwd, ksk.key_rows(L_t), ks_ctx)  # [..., 2, L_ks, N]
    inv = nttmod.inverse_ntt(acc, ks_ctx.ntt_tables)
    switches["key_switch"] += 1
    return ks.ks_finish(inv, ks_ctx, c0, c1, element, index)  # [..., 2, L_t, N]


def compute_key_switching_update(context, target: PolyRq, ksk: KeySwitchKey) -> list[PolyRq]:
    """Key-switching update for a Coeff target [..., L_t, N]: returns one
    Coeff poly over the target's context per key component
    (reference Bfv+Keys.swift:123-208)."""
    if target.fmt != COEFF:
        raise errors.InvalidFormat("key switch target must be Coeff")
    out = key_switch(context, target.data, ksk)
    return [PolyRq(out[..., c, :, :], target.context, COEFF) for c in range(out.shape[-3])]
