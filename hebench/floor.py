"""The bytes a batch of PIR work has to move, from the configuration's
shapes alone (never from kernel names or launch counts, so a change that
fuses, splits or removes kernels reads against the same work).

Every residue counts at its modulus' bit width (a q of 27 bits moves 27
bits, whatever word holds it). With N the degree, Lq the bits of one
coefficient over the ciphertext moduli, k the bits of the key-switching
modulus, L the number of ciphertext moduli and B the batch:

- a polynomial over the ciphertext moduli: P = N Lq / 8 bytes;
- a key-switch key: L digit ciphertexts of 2 polynomials over the
  ciphertext moduli and q_ks: K = 2 L N (Lq + k) / 8 bytes;
- expansion: the queries read once, B x query ciphertexts x 2P; each
  level's Galois key read once, levels x K; the expanded ciphertexts
  written once, B x expanded x 2P;
- dim-0: the database's Eval-form plaintexts read once, plaintexts x P;
- BEHZ and relinearization: the relinearization key read once, K (only
  with more than one dimension);
- mod switch: the answers written once, over the first modulus alone,
  B x indices x chunks x 2 N q0 / 8.
"""

from __future__ import annotations


def ceil_log2(x: int) -> int:
    return (x - 1).bit_length()


def expansion_levels(shape: dict) -> int:
    """Levels of the expansion tree of one query ciphertext: its inputs
    are min(expanded, N)."""
    return ceil_log2(min(shape["expanded_per_query"], shape["degree"]))


def floor_bytes(shape: dict, batch: int) -> dict:
    """Bytes a batch has to move, by stage, and their total."""
    n = shape["degree"]
    ct_bits = sum(shape["ciphertext_moduli_bits"])
    moduli = len(shape["ciphertext_moduli_bits"])
    poly = n * ct_bits / 8
    key = 2 * moduli * n * (ct_bits + shape["key_switch_modulus_bits"]) / 8
    stages = {
        "expand": batch * shape["query_ciphertexts"] * 2 * poly
        + expansion_levels(shape) * key
        + batch * shape["expanded_per_query"] * 2 * poly,
        "dim0": shape["plaintexts"] * poly,
        "behz": key if len(shape["dimensions"]) > 1 else 0.0,
        "mod_switch": batch * shape["indices"] * shape["chunks"] * 2 * n * shape["ciphertext_moduli_bits"][0] / 8,
    }
    stages["total"] = sum(stages.values())
    return stages
