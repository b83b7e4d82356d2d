"""Polynomial samplers: uniform / ternary / centered binomial.

A copy of she_tpu.rng.sampling with two changes: samplers return int64
numpy arrays (every supported modulus is below 2^62) instead of object
arrays, so the port uploads them to torch without a Python-int pass; and
`sample_uniform_many` draws the uniform polys of many seeds at once (a
server expanding a batch of seeded ciphertexts).

Byte-consumption order is bit-identical to the reference so that seeded
uniform polynomials (ciphertext seed compression) interoperate
(reference: Sources/HomomorphicEncryption/PolyRq/PolyRq+Randomize.swift:58-180).

Samplers run on the host and return arrays shaped [L, N] (RNS-major),
holding fully reduced values in [0, q_i).
"""

from __future__ import annotations

import math

import numpy as np


def _reduce_u128(data: np.ndarray, q: int) -> np.ndarray:
    """uint8 [..., 16 n] little-endian u128s -> int64 [..., n] values mod q."""
    if q < (1 << 32):
        # exact u128 % q fully in uint64: MSB-first Horner over the four
        # u32 limbs; r < q < 2^32 keeps r*2^32 + limb < 2^64.
        limbs = np.ascontiguousarray(data).view("<u4").reshape(data.shape[:-1] + (-1, 4))
        qv = np.uint64(q)
        r = np.zeros(limbs.shape[:-1], dtype=np.uint64)
        for j in (3, 2, 1, 0):
            r = (r * np.uint64(1 << 32) + limbs[..., j].astype(np.uint64)) % qv
        return r.astype(np.int64)
    # u128 % q via two u64 halves (object big-int fallback)
    u = np.ascontiguousarray(data).view("<u8").reshape(data.shape[:-1] + (-1, 2))
    lo = u[..., 0].astype(object)
    hi = u[..., 1].astype(object)
    return ((hi * (1 << 64) + lo) % q).astype(np.int64)


def sample_uniform(rng, moduli: list[int], degree: int) -> np.ndarray:
    """Uniform in [0, q_i) per RNS row.

    Per reference: chunks of min(N, 1024) coefficients; each coefficient
    consumes 16 bytes (little-endian u128) reduced mod q_i; RNS rows are
    sampled in order (PolyRq+Randomize.swift:58-85).
    """
    chunk = min(degree, 1024)
    out = np.zeros((len(moduli), degree), dtype=np.int64)
    for rns_index, q in enumerate(moduli):
        for base in range(0, degree, chunk):
            data = np.frombuffer(rng.random_bytes(chunk * 16), dtype=np.uint8)
            out[rns_index, base : base + chunk] = _reduce_u128(data, q)
    return out


def sample_uniform_many(seeds: list, moduli: list[int], degree: int) -> np.ndarray:
    """int64 [len(seeds), L, N]: sample_uniform(nist_aes128_ctr(seed)) for
    every seed, with the generators run in lockstep. The requests of
    sample_uniform read the buffered stream in order, so row i is bytes
    [16 N i, 16 N (i + 1)) of the stream."""
    from .ctr_drbg import nist_aes128_ctr_streams

    stream = nist_aes128_ctr_streams(seeds, len(moduli) * degree * 16)
    rows = stream.reshape(len(seeds), len(moduli), degree * 16)
    return np.stack([_reduce_u128(rows[:, i], q) for i, q in enumerate(moduli)], axis=1)


def sample_ternary(rng, moduli: list[int], degree: int) -> np.ndarray:
    """Ternary {-1, 0, 1} secret, represented mod each q_i.

    Per coefficient: u64 then u32 from the stream, u128 = u64<<32 | u32,
    val = u128 % 3, mapped to val - 1 mod q_i
    (PolyRq+Randomize.swift:88-117).
    """
    # Consume bytes in the same order: 8 bytes then 4 bytes per coefficient.
    data = rng.random_bytes(degree * 12)
    raw = np.frombuffer(data, dtype=np.uint8).reshape(degree, 12)
    u64 = raw[:, :8].copy().view("<u8")[:, 0]
    u32 = raw[:, 8:].copy().view("<u4")[:, 0].astype(np.uint64)
    # (u64<<32 | u32) % 3 exactly in uint64 via Horner: r < 3 keeps
    # r*2^32 + u32 < 2^34.
    r = (u64 % np.uint64(3)) * np.uint64(1 << 32) + u32
    vals = (r % np.uint64(3)).astype(np.int64)
    out = np.zeros((len(moduli), degree), dtype=np.int64)
    for rns_index, q in enumerate(moduli):
        row = vals - 1  # in {-1, 0, 1}
        out[rns_index] = np.where(row < 0, row + q, row)
    return out


_BYTE_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)


def _popcount_u64(words: np.ndarray) -> np.ndarray:
    """Per-element popcount of a uint64 array (np.bitwise_count needs
    numpy >= 2, which not every supported installation has)."""
    as_bytes = words.view(np.uint8).reshape(words.shape + (8,))
    return _BYTE_POPCOUNT[as_bytes].sum(axis=-1)


def cbd_k(std_dev: float) -> int:
    """Number of bit-pairs for the centered binomial: k = ceil(2 sigma^2)."""
    return math.ceil(2 * std_dev * std_dev)


def sample_centered_binomial(rng, moduli: list[int], degree: int, std_dev: float) -> np.ndarray:
    """Centered binomial error polynomial, represented mod each q_i.

    k = ceil(2 sigma^2) (=21 for sigma=3.2); per coefficient two u64 draws,
    masked to k bits each; value = popcount(t0) - popcount(t1)
    (PolyRq+Randomize.swift:127-180).
    """
    k = cbd_k(std_dev)
    n_u64 = 2 * ((k + 63) // 64)
    half = n_u64 // 2
    mask = (1 << (k % 64)) - 1 if k % 64 != 0 else (1 << 64) - 1
    # bulk-draw the byte stream (identical order: n_u64 sequential u64 LE
    # draws per coefficient) and popcount vectorized
    data = rng.random_bytes(degree * n_u64 * 8)
    trials = np.frombuffer(data, dtype="<u8").reshape(degree, n_u64).copy()
    trials[:, half - 1] &= np.uint64(mask)
    trials[:, n_u64 - 1] &= np.uint64(mask)
    counts = _popcount_u64(trials)
    vals = counts[:, :half].sum(axis=1) - counts[:, half:].sum(axis=1)
    out = np.zeros((len(moduli), degree), dtype=np.int64)
    for rns_index, q in enumerate(moduli):
        out[rns_index] = np.where(vals < 0, vals + q, vals)
    return out
