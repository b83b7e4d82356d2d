"""Carry state between she_tpu's uint32 limb layout and the port's int64.

she_tpu stores a polynomial as a uint32 limb array [W, ..., L, N]
(W = 1 limb for w32 moduli, 2 for w64; ops/word.py pack/unpack); the port
stores one int64 word per coefficient, [..., L, N]. The functions here
convert plain numpy arrays in both directions, and rebuild the port's
secret key, evaluation key, processed database and queries from such
arrays, so both packages can be fed the same state. Evaluation-key
generation draws fresh seeds, so a comparison has to carry keys across,
not regenerate them. This module works on arrays only and imports nothing
of she_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from .bfv import bfv, keys
from .core.poly import COEFF, EVAL, PolyRq
from .pir import index_pir as ip


def limbs_to_int64(limbs) -> np.ndarray:
    """uint32 [W, ..., L, N] -> int64 [..., L, N]."""
    limbs = np.asarray(limbs, dtype=np.uint32)
    out = limbs[0].astype(np.uint64)
    for i in range(1, limbs.shape[0]):
        out |= limbs[i].astype(np.uint64) << np.uint64(32 * i)
    return out.astype(np.int64)  # every modulus is below 2^62


def int64_to_limbs(values, nlimbs: int) -> np.ndarray:
    """int64 [..., L, N] (non-negative) -> uint32 [W, ..., L, N]."""
    v = np.asarray(values, dtype=np.int64).astype(np.uint64)
    return np.stack(
        [((v >> np.uint64(32 * i)) & np.uint64(0xFFFFFFFF)).astype(np.uint32) for i in range(nlimbs)]
    )


def tensor_from_limbs(limbs, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(limbs_to_int64(limbs))).to(device)


def limbs_from_tensor(t: torch.Tensor, nlimbs: int) -> np.ndarray:
    return int64_to_limbs(t.detach().cpu().numpy(), nlimbs)


def _nlimbs(context) -> int:
    return 1 if context.params.scalar_bits == 32 else 2


def _poly_context_for_rows(context, rows: int):
    """The context of a [rows, N] polynomial: the secret-key / top
    key-switching moduli, or a prefix of the ciphertext moduli."""
    if rows == len(context.secret_key_context.moduli) and rows > len(context.ciphertext_context.moduli):
        return context.secret_key_context
    return context.ciphertext_context.get_context(rows)


# -- secret key -------------------------------------------------------------


def secret_key_from_limbs(context, limbs) -> bfv.SecretKey:
    """limbs: uint32 [W, L_all, N] Eval secret key."""
    data = tensor_from_limbs(limbs, context.device)
    return bfv.SecretKey(PolyRq(data, context.secret_key_context, EVAL))


def secret_key_to_limbs(secret_key: bfv.SecretKey) -> np.ndarray:
    ctx = secret_key.poly.context
    return limbs_from_tensor(secret_key.poly.data, 1 if ctx.scalar_bits == 32 else 2)


# -- ciphertexts and queries -------------------------------------------------


def ciphertext_from_limbs(context, polys, fmt: str = COEFF, correction_factor: int = 1,
                          seed: bytes | None = None) -> bfv.Ciphertext:
    """polys: per poly, uint32 [W, L, N]."""
    data = [tensor_from_limbs(p, context.device) for p in polys]
    poly_ctx = _poly_context_for_rows(context, data[0].shape[-2])
    return bfv.Ciphertext(context, [PolyRq(d, poly_ctx, fmt) for d in data], correction_factor, seed)


def ciphertext_to_limbs(ct: bfv.Ciphertext) -> list[np.ndarray]:
    """Per poly, uint32 [W, L, N]."""
    return [limbs_from_tensor(p.data, _nlimbs(ct.context)) for p in ct.polys]


def query_from_limbs(context, ciphertexts, indices_count: int) -> ip.Query:
    """ciphertexts: per query ciphertext, a list of per-poly [W, L, N] limbs."""
    return ip.Query([ciphertext_from_limbs(context, c) for c in ciphertexts], indices_count)


# -- evaluation key -----------------------------------------------------------


def _key_switch_key_from_limbs(context, cts) -> keys.KeySwitchKey:
    return keys.KeySwitchKey([ciphertext_from_limbs(context, c, EVAL) for c in cts])


def evaluation_key_from_limbs(context, galois: dict | None, relinearization: list | None) -> keys.EvaluationKey:
    """galois: element -> per decomposition digit, per poly [W, L, N] limbs;
    relinearization: per digit, per poly limbs (either may be None)."""
    gk = None
    if galois is not None:
        gk = keys.GaloisKey({e: _key_switch_key_from_limbs(context, cts) for e, cts in galois.items()})
    rk = None
    if relinearization is not None:
        rk = keys.RelinearizationKey(_key_switch_key_from_limbs(context, relinearization))
    return keys.EvaluationKey(gk, rk)


def evaluation_key_to_limbs(ek: keys.EvaluationKey) -> tuple[dict | None, list | None]:
    def ksk(k):
        return [ciphertext_to_limbs(ct) for ct in k.ciphertexts]

    galois = None if ek.galois_key is None else {e: ksk(k) for e, k in ek.galois_key.keys.items()}
    relin = None if ek.relinearization_key is None else ksk(ek.relinearization_key.key_switch_key)
    return galois, relin


# -- processed database -----------------------------------------------------------


def processed_database_from_limbs(context, plaintexts: list) -> ip.ProcessedDatabase:
    """plaintexts: per plaintext, uint32 [W, L, N] Eval limbs, or None for a
    skipped zero plaintext."""
    ctx = context.ciphertext_context
    shape = (len(ctx.moduli), ctx.degree)
    rows = np.zeros((len(plaintexts),) + shape, dtype=np.int64)
    present = np.zeros(len(plaintexts), dtype=bool)
    for i, p in enumerate(plaintexts):
        if p is not None:
            rows[i] = limbs_to_int64(p)
            present[i] = True
    data = torch.from_numpy(rows).to(context.device)
    return ip.ProcessedDatabase(context, data, present)


def processed_database_to_limbs(db: ip.ProcessedDatabase) -> list:
    nl = _nlimbs(db.context)
    arr = int64_to_limbs(db.data.cpu().numpy(), nl)  # [W, count, L, N]
    return [arr[:, i] if db.present[i] else None for i in range(db.count)]
