"""Fixed-width coefficient bit-packing (the part of she_tpu/io/serialize.py
that PIR entry packing needs).

Big-endian bitstream of (bitsPerCoeff - skipLSBs)-bit fields, as in the
reference (Sources/HomomorphicEncryption/CoefficientPacking.swift:34-217).
`bytes_to_coefficients_rows` is the vectorized form used by database
processing: it unpacks many equal-length byte rows in one numpy pass.
"""

from __future__ import annotations

import numpy as np

from .. import errors


def ceil_log2(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


def floor_log2(x: int) -> int:
    return x.bit_length() - 1


def coefficients_to_bytes_byte_count(coeff_count: int, bits_per_coeff: int, skip_lsbs: int = 0) -> int:
    serialized = bits_per_coeff - skip_lsbs
    return -(-(coeff_count * serialized) // 8)


def bytes_to_coefficients_coeff_count(byte_count: int, bits_per_coeff: int, decode: bool, skip_lsbs: int = 0) -> int:
    serialized = bits_per_coeff - skip_lsbs
    if decode:
        return 8 * byte_count // serialized
    return -(-(8 * byte_count) // serialized)


def _validate(bits_per_coeff: int, skip_lsbs: int):
    if not (0 < bits_per_coeff <= 64 and bits_per_coeff > skip_lsbs and skip_lsbs >= 0):
        raise errors.SerializationError(
            f"invalid packing bitsPerCoeff={bits_per_coeff} skipLSBs={skip_lsbs}"
        )


def coefficients_to_bytes(coeffs, bits_per_coeff: int, skip_lsbs: int = 0) -> bytes:
    """coeffs: array of ints -> MSB-first bitstream of truncated coeffs."""
    _validate(bits_per_coeff, skip_lsbs)
    sbc = bits_per_coeff - skip_lsbs
    arr = np.asarray(coeffs).astype(np.uint64) >> np.uint64(skip_lsbs)
    n = len(arr)
    shifts = np.arange(sbc - 1, -1, -1, dtype=np.uint64)
    bits = ((arr[:, None] >> shifts[None, :]) & np.uint64(1)).astype(np.uint8)
    flat = bits.reshape(-1)
    nbytes = coefficients_to_bytes_byte_count(n, bits_per_coeff, skip_lsbs)
    padded = np.zeros(nbytes * 8, dtype=np.uint8)
    padded[: len(flat)] = flat
    return np.packbits(padded).tobytes()


def bytes_to_coefficients_rows(
    rows: np.ndarray, bits_per_coeff: int, decode: bool, skip_lsbs: int = 0
) -> np.ndarray:
    """uint8 [R, B] byte rows -> int64 [R, count] coefficients, each row
    unpacked as bytes_to_coefficients would unpack its B bytes."""
    _validate(bits_per_coeff, skip_lsbs)
    rows = np.asarray(rows, dtype=np.uint8)
    if rows.ndim != 2:
        raise errors.SerializationError(f"expected [rows, bytes], got {rows.shape}")
    sbc = bits_per_coeff - skip_lsbs
    count = bytes_to_coefficients_coeff_count(rows.shape[1], bits_per_coeff, decode, skip_lsbs)
    bits = np.unpackbits(rows, axis=1)
    need = count * sbc
    if bits.shape[1] < need:
        bits = np.pad(bits, ((0, 0), (0, need - bits.shape[1])))
    bits = bits[:, :need].reshape(rows.shape[0], count, sbc)
    weights = np.uint64(1) << np.arange(sbc - 1, -1, -1, dtype=np.uint64)
    out = (bits.astype(np.uint64) * weights).sum(axis=2, dtype=np.uint64)
    return (out << np.uint64(skip_lsbs)).astype(np.int64)


def bytes_to_coefficients(data: bytes, bits_per_coeff: int, decode: bool, skip_lsbs: int = 0) -> np.ndarray:
    """Inverse of coefficients_to_bytes -> int64 array."""
    row = np.frombuffer(bytes(data), dtype=np.uint8)[None, :]
    return bytes_to_coefficients_rows(row, bits_per_coeff, decode, skip_lsbs)[0]
