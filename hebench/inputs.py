"""The inputs of a cell, made from its seed: the secret's raw bytes, the
error stream of the keys, and the query batches.

The port receives only what a client would send it. The secret key is made
by the port's `generate_secret_key` from raw bytes that this module draws;
the reference reads the same bytes (reference/bfv.ternary_secret). A query
is a fresh encryption of the plaintext a client's query holds (a value at
each slot it selects, as the Swift reference's query compression writes
it), made in bulk on the device: a few encryptions of zero by the port's
`encrypt_zero`, each query one of them times a negacyclic power x^k drawn
from the seed (again an encryption of zero, with the noise of a fresh one),
plus round(Q v / t) at the selected slots of c0.
"""

from __future__ import annotations

import numpy as np
import torch

BASE_ENCRYPTIONS = 16


class SeededBytes:
    """The random-byte interface the port's samplers read, from a seeded
    numpy generator."""

    def __init__(self, seed: int):
        self._rng = np.random.default_rng(seed)

    def random_bytes(self, n: int) -> bytes:
        return self._rng.bytes(n)


class FixedBytes(SeededBytes):
    """Hands out exactly the bytes it was given, once."""

    def __init__(self, data: bytes):
        self._data, self._at = data, 0

    def random_bytes(self, n: int) -> bytes:
        if self._at + n > len(self._data):
            raise ValueError(f"asked for {n} bytes, {len(self._data) - self._at} left")
        out = self._data[self._at : self._at + n]
        self._at += n
        return out


def secret_bytes(seed: int, degree: int) -> bytes:
    """The 12 N bytes the ternary secret is sampled from."""
    return np.random.default_rng([seed, 1]).bytes(12 * degree)


def ceil_log2(x: int) -> int:
    return (x - 1).bit_length()


def query_slots(one_indices: list, total: int, degree: int) -> list:
    """Per query ciphertext, the slots it selects: input j of `total`
    lies in ciphertext j // N at slot j % N (PirUtil.swift:361-404)."""
    count = -(-total // degree)
    slots = [[] for _ in range(count)]
    for j in one_indices:
        slots[j // degree].append(j % degree)
    return slots


def slot_value(total: int, ct_index: int, degree: int, t: int) -> int:
    """The value at a selected slot: 2^-ceil(log2 n) mod t, where n is the
    number of inputs the ciphertext carries."""
    n = min(total - ct_index * degree, degree)
    return pow(pow(2, ceil_log2(n), t), -1, t)


def _rotate(data: torch.Tensor, powers: torch.Tensor, moduli: torch.Tensor) -> torch.Tensor:
    """data [Q, 2, L, N] times x^k (k = powers[q], 0 <= k < 2N) mod x^N + 1."""
    n = data.shape[-1]
    j = torch.arange(n, device=data.device)
    k = powers.view(-1, 1, 1, 1)
    src = torch.remainder(j - k, n)
    out = torch.gather(data, -1, src.expand(data.shape))
    # coefficients that wrapped an odd number of times change sign
    flips = torch.div(k - j + (n - 1), n, rounding_mode="floor") % 2 == 1
    q = moduli.view(1, 1, -1, 1)
    negated = torch.remainder(q - out, q)
    return torch.where(flips, negated, out)


def encrypt_batch(ctx, secret_key, plaintext_slots: list, seed: int) -> torch.Tensor:
    """int64 [Q, 2, L, N] Coeff ciphertexts over the ciphertext moduli,
    the q-th encrypting plaintext_slots[q] = (value, slots)."""
    from she_tpu_torch.bfv import bfv

    rng = np.random.default_rng([seed, 2])
    err = SeededBytes(int(rng.integers(0, 2**63)))
    bases = torch.stack([
        bfv.encrypt_zero(ctx, secret_key, seed=rng.bytes(32), err_rng=err).stacked()
        for _ in range(BASE_ENCRYPTIONS)
    ])
    n = ctx.degree
    moduli_list = list(ctx.ciphertext_context.moduli)
    moduli = torch.tensor(moduli_list, dtype=torch.int64, device=bases.device)
    count = len(plaintext_slots)
    pick = torch.as_tensor(rng.integers(0, BASE_ENCRYPTIONS, size=count), device=bases.device)
    powers = torch.as_tensor(rng.integers(0, 2 * n, size=count), device=bases.device)
    out = _rotate(bases[pick], powers, moduli)
    t = ctx.plaintext_modulus
    q_all = 1
    for q in moduli_list:
        q_all *= q
    rows, cols, adds = [], [], []
    for index, (value, slots) in enumerate(plaintext_slots):
        # round(Q v / t) as the port's encryption adds it (Bfv+Encrypt.swift:75-139)
        scaled = (q_all // t) * value + ((q_all % t) * value + (t + 1) // 2) // t
        for slot in slots:
            rows.append(index)
            cols.append(slot)
            adds.append([scaled % q for q in moduli_list])
    if rows:
        r = torch.tensor(rows, device=out.device)
        c = torch.tensor(cols, device=out.device)
        add = torch.tensor(adds, dtype=torch.int64, device=out.device)  # [S, L]
        c0 = out[r, 0, :, c]  # [S, L]
        out[r, 0, :, c] = torch.remainder(c0 + add, moduli.view(1, -1))
    return out


def make_queries(ctx, secret_key, one_indices: list, total: int, indices_count: int, seed: int) -> list:
    """ip.Query objects, one per entry of one_indices (the inputs each
    query selects among `total`), on the context's device."""
    from she_tpu_torch.bfv import bfv
    from she_tpu_torch.pir import index_pir as ip

    n, t = ctx.degree, ctx.plaintext_modulus
    per_query = [query_slots(ones, total, n) for ones in one_indices]
    cts = len(per_query[0])
    flat = [(slot_value(total, c, n, t), slots[c]) for slots in per_query for c in range(cts)]
    data = encrypt_batch(ctx, secret_key, flat, seed)
    poly_ctx = ctx.ciphertext_context
    queries = []
    for qi in range(len(per_query)):
        ciphertexts = [bfv.Ciphertext.from_stacked(ctx, data[qi * cts + c], poly_ctx) for c in range(cts)]
        queries.append(ip.Query(ciphertexts, indices_count))
    return queries


def one_indices(index_client, indices: list) -> list:
    """The inputs a MulPIR query for `indices` selects: per index, its
    coordinate in each dimension, the dimensions laid end to end
    (MulPir.swift's query generation)."""
    out, offset = [], 0
    dims = index_client.parameter.dimensions
    for index in indices:
        for coord, size in zip(index_client.compute_coordinates(index), dims):
            out.append(offset + coord)
            offset += size
    return out
