"""Plain BFV decryption, to judge the answers a PIR server sends.

Written from the scheme's definition alone (Brakerski/Fan-Vercauteren,
eprint 2012/144; the secret sampling of the Swift reference,
PolyRq+Randomize.swift): it imports torch and numpy, nothing of the
program under test. An answer is a ciphertext (c0, c1) over one modulus q
in coefficient form; with the ternary secret s,

    v = c0 + c1 * s  mod (q, x^N + 1),   m = round(t v / q) mod t,

and its noise is v - round(q m / t), centred mod q. An answer decrypts to
m while every |noise| stays below q / (2 t).

The product c1 * s is exact: c1 is cut into 16-bit limbs, each limb times
the negacyclic matrix of s is a float64 matrix product whose every partial
sum is an integer below 2^53, and the limbs are put together mod q in
int64 (Horner, shifting a few bits at a time so nothing overflows).
"""

from __future__ import annotations

import numpy as np
import torch

LIMB_BITS = 16


def ternary_secret(raw: bytes, degree: int) -> np.ndarray:
    """The ternary secret {-1, 0, 1}^N that `raw` (12 bytes a coefficient)
    gives: per coefficient a little-endian u64 then u32, (u64 << 32 | u32)
    mod 3, minus 1 (the Swift reference's PolyRq+Randomize.swift:88-117)."""
    if len(raw) != 12 * degree:
        raise ValueError(f"{len(raw)} secret bytes for degree {degree}, expected {12 * degree}")
    out = np.empty(degree, dtype=np.int64)
    for i in range(degree):
        u64 = int.from_bytes(raw[12 * i : 12 * i + 8], "little")
        u32 = int.from_bytes(raw[12 * i + 8 : 12 * i + 12], "little")
        out[i] = ((u64 << 32) | u32) % 3 - 1
    return out


def negacyclic_matrix(secret: np.ndarray, device) -> torch.Tensor:
    """float64 [N, N] S with (c @ S)[i] = sum_j c[j] s[i - j] (mod x^N + 1)."""
    n = secret.shape[0]
    s = torch.as_tensor(secret, dtype=torch.float64, device=device)
    i = torch.arange(n, device=device)
    diff = i[None, :] - i[:, None]  # [j, i]: i - j
    matrix = s[torch.remainder(diff, n)]
    return torch.where(diff >= 0, matrix, -matrix)


def _shift_mod(x: torch.Tensor, bits: int, q: int, step: int) -> torch.Tensor:
    """x * 2^bits mod q for 0 <= x < q, `step` bits at a time."""
    while bits > 0:
        k = min(step, bits)
        x = torch.remainder(x << k, q)
        bits -= k
    return x


def dot_with_secret(c0: torch.Tensor, c1: torch.Tensor, matrix: torch.Tensor, q: int, block: int = 256) -> torch.Tensor:
    """v = c0 + c1 * s mod q: int64 [A, N] in [0, q), for c0, c1 int64
    [A, N] in [0, q) and S = negacyclic_matrix(s)."""
    n = c1.shape[-1]
    q_bits = q.bit_length()
    if q_bits > 61 or n * (1 << LIMB_BITS) >= 1 << 52:
        raise ValueError(f"modulus of {q_bits} bits at degree {n} is outside the exact range")
    limbs = -(-q_bits // LIMB_BITS)
    step = 62 - q_bits
    out = []
    for start in range(0, c1.shape[0], block):
        part = c1[start : start + block].to(matrix.device)
        acc = torch.zeros_like(part)
        for k in reversed(range(limbs)):
            limb = ((part >> (LIMB_BITS * k)) & ((1 << LIMB_BITS) - 1)).to(torch.float64)
            conv = torch.round(limb @ matrix).to(torch.int64)  # exact: |sum| < N 2^16 < 2^52
            acc = torch.remainder(_shift_mod(acc, LIMB_BITS, q, step) + conv, q)
        out.append(torch.remainder(acc + c0[start : start + block].to(matrix.device), q))
    return torch.cat(out)


def _nearest_multiple(m: torch.Tensor, q: int, t: int) -> torch.Tensor:
    """round(q m / t) mod q for 0 <= m < t, exactly in int64."""
    delta, r = divmod(q, t)
    return torch.remainder(delta * m + torch.div(2 * r * m + t, 2 * t, rounding_mode="floor"), q)


def decrypt(v: torch.Tensor, q: int, t: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(m, noise), int64 [A, N] each: m = round(t v / q) mod t, and
    noise = v - round(q m / t) centred mod q."""
    if t.bit_length() > 30:
        raise ValueError("plaintext modulus above 2^30")
    scaled = v.to(torch.float64) * (t / q)
    m = torch.floor(scaled + 0.5)
    # float64 carries t v / q to about 2^-30 at these sizes; a value that
    # close to a rounding boundary is settled with exact integers
    near = (scaled - torch.floor(scaled) - 0.5).abs() < 1e-6
    m = m.to(torch.int64)
    if bool(near.any()):
        flat_v, flat_m = v.reshape(-1), m.reshape(-1)
        for idx in torch.nonzero(near.reshape(-1)).flatten().tolist():
            flat_m[idx] = (t * int(flat_v[idx]) + q // 2) // q
        m = flat_m.reshape(v.shape)
    m = torch.remainder(m, t)
    noise = torch.remainder(v - _nearest_multiple(m, q, t), q)
    noise = torch.where(noise > q // 2, noise - q, noise)
    return m, noise


def noise_share(noise: torch.Tensor, q: int, t: int) -> float:
    """The largest |noise| as a share of q / (2 t), the most an answer may
    carry and still decrypt."""
    if noise.numel() == 0:
        raise ValueError("no noise to read")
    return float(noise.abs().max().item()) / (q / (2 * t))


def floor_log2(x: int) -> int:
    return x.bit_length() - 1


def bytes_per_plaintext(degree: int, t: int) -> int:
    return degree * floor_log2(t) // 8


def coefficients_to_bytes(m: np.ndarray, bits: int) -> bytes:
    """Coefficients < 2^bits -> their MSB-first bitstream, zero-padded to
    whole bytes (the coefficient encoding of the Swift reference's
    CoefficientPacking.swift)."""
    m = np.asarray(m, dtype=np.uint64)
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint64)
    stream = ((m[:, None] >> shifts) & np.uint64(1)).astype(np.uint8).reshape(-1)
    return np.packbits(stream).tobytes()


def bytes_to_coefficients(data: bytes, bits: int, degree: int) -> np.ndarray:
    """The inverse: `data`'s MSB-first bitstream cut into `degree`
    bits-wide fields, zero past its end."""
    stream = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
    need = degree * bits
    if stream.size > need:
        raise ValueError(f"{len(data)} bytes do not fit {degree} coefficients of {bits} bits")
    stream = np.pad(stream, (0, need - stream.size)).reshape(degree, bits).astype(np.int64)
    return stream @ (np.int64(1) << np.arange(bits - 1, -1, -1, dtype=np.int64))
